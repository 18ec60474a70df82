"""The building blocks UNet3D uses, channels-last (NDHWC).

Parameters are float32 and keep the JAX package's layouts, so converted
checkpoints need no transposes: conv kernels are [kd, kh, kw, Cin, Cout].
Each block computes in its ``dtype`` (float32 or bfloat16) by casting its
input and weights explicitly, as the JAX blocks do; BatchNorm folding and
biases stay float32. Kernels are initialised by ``config.init_type``
(``nn.init``) from the ``torch.Generator`` the model passes in.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.conv3d_bn_relu import conv3d_bn_relu, conv3d_k3s1, fold_batchnorm
from .init import bias_initializer, kernel_initializer
from .norm import BatchNorm


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class TorchConv(nn.Module):
    """k3 s1 p1 Conv3d with bias; ``weight`` is [3, 3, 3, Cin, Cout].

    Runs ``conv3d_k3s1``: the hand-written kernels on a card (forward,
    input gradient and weight gradient), their plain versions on the CPU."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
        init_type: str = "none", generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        gen = _generator(generator)
        self.weight = nn.Parameter(kernel_initializer(init_type)((3, 3, 3, cin, cout), gen))
        self.bias = nn.Parameter(bias_initializer(init_type)((cout,), gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d_k3s1(x.to(self.dtype).contiguous(), self.weight, self.bias)


class ConvBlock(nn.Module):
    """Conv3d(k3, p1) -> BatchNorm -> ReLU, UNet3D's block.

    In eval mode BatchNorm is folded into the conv (in f32) and the block is
    one ``conv3d_bn_relu`` call: the CUDA kernel on a card, its plain
    version on the CPU. Train mode runs ``TorchConv`` (the kernels with
    their gradients), then train-mode BatchNorm and ReLU with autograd."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
        init_type: str = "none", generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.conv = TorchConv(cin, cout, dtype, init_type, generator)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return torch.relu(self.bn(self.conv(x)))
        w, b = fold_batchnorm(
            self.conv.weight, self.conv.bias, self.bn.weight, self.bn.bias,
            self.bn.running_mean, self.bn.running_var, self.bn.eps,
        )
        return conv3d_bn_relu(x.to(self.dtype).contiguous(), w.to(self.dtype), b)


class TorchConvTranspose(nn.Module):
    """ConvTranspose3d with kernel 2, stride 2, as one matmul and a pixel
    shuffle. ``weight`` is [2, 2, 2, Cin, Cout] in the JAX convention,
    which applies the kernel spatially flipped: torch's ConvTranspose3d
    weight [Cin, Cout, kd, kh, kw] is ``weight.flip((0, 1, 2))`` permuted."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
        init_type: str = "none", generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        gen = _generator(generator)
        self.weight = nn.Parameter(kernel_initializer(init_type)((2, 2, 2, cin, cout), gen))
        self.bias = nn.Parameter(bias_initializer(init_type)((cout,), gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, d, h, w, cin = x.shape
        cout = self.weight.shape[-1]
        k = self.weight.flip((0, 1, 2)).permute(3, 0, 1, 2, 4).reshape(cin, 8 * cout)
        y = x.to(self.dtype).reshape(-1, cin) @ k.to(self.dtype)
        y = y.reshape(n, d, h, w, 2, 2, 2, cout).permute(0, 1, 4, 2, 5, 3, 6, 7)
        return y.reshape(n, 2 * d, 2 * h, 2 * w, cout) + self.bias.to(self.dtype)


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MaxPool3d(window) with stride = window on NDHWC (floor output size)."""
    n, d, h, w, c = x.shape
    d2, h2, w2 = d // window, h // window, w // window
    x = x[:, : d2 * window, : h2 * window, : w2 * window]
    return x.reshape(n, d2, window, h2, window, w2, window, c).amax(dim=(2, 4, 6))
