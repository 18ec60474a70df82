"""The building blocks UNet3D and UNet2D use, channels-last (NDHWC / NHWC).

Parameters are float32 and keep the JAX package's layouts, so converted
checkpoints need no transposes: conv kernels are [kd, kh, kw, Cin, Cout]
in 3-D and [kh, kw, Cin, Cout] in 2-D; a block's spatial rank is its
weight's rank less two.
Each block computes in its ``dtype`` (float32 or bfloat16) by casting its
input and weights explicitly, as the JAX blocks do; BatchNorm folding and
biases stay float32. Kernels are initialised by ``config.init_type``
(``nn.init``) from the ``torch.Generator`` the model passes in.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv3d_bn_relu import conv2d_bn_relu, conv2d_k3s1, conv3d_bn_relu, conv3d_k3s1, fold_batchnorm
from .init import bias_initializer, kernel_initializer
from .norm import BatchNorm


# ConvBlock.remat: None (no remat), or what the backward recomputes
REMAT_POLICIES = (None, "full", "conv", "dots")


def remat_policy(name: Optional[str]) -> str:
    """``config.remat_policy`` -> ``ConvBlock.remat``: '' and 'full'
    recompute the whole block, 'conv' and 'dots' keep the conv's output;
    anything else raises ``ValueError`` as the JAX package does."""
    if not name or name == "full":
        return "full"
    if name in ("conv", "dots"):
        return name
    raise ValueError(f"unknown remat_policy {name!r}")


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class TorchConv(nn.Module):
    """Conv with bias over ``ndim`` spatial axes (3 or 2); ``weight`` is
    [k, .., k, Cin, Cout].

    ``kernel_size=3`` is the k3 s1 p1 conv, run by ``conv3d_k3s1`` or
    ``conv2d_k3s1``: the hand-written kernels on a card (forward, input
    gradient and weight gradient), their plain versions on the CPU.
    ``kernel_size=1`` is the pointwise conv of a head, one matmul over the
    channels."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
        init_type: str = "none", generator: Optional[torch.Generator] = None,
        ndim: int = 3, kernel_size: int = 3,
    ):
        super().__init__()
        if ndim not in (2, 3) or kernel_size not in (1, 3):
            raise ValueError(f"TorchConv: ndim must be 2 or 3 and kernel_size 1 or 3, got {ndim}, {kernel_size}")
        self.dtype, self.ndim, self.kernel_size = dtype, ndim, kernel_size
        gen = _generator(generator)
        self.weight = nn.Parameter(kernel_initializer(init_type)((kernel_size,) * ndim + (cin, cout), gen))
        self.bias = nn.Parameter(bias_initializer(init_type)((cout,), gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.kernel_size == 1:
            w = self.weight.reshape(self.weight.shape[-2:]).to(self.dtype)
            return x @ w + self.bias.to(self.dtype)
        conv = conv3d_k3s1 if self.ndim == 3 else conv2d_k3s1
        return conv(x.contiguous(), self.weight, self.bias)


class ConvBlock(nn.Module):
    """Conv(k3, p1) -> BatchNorm -> ReLU over ``ndim`` spatial axes: the
    block of UNet3D (3) and of UNet2D (2).

    In eval mode BatchNorm is folded into the conv (in f32) and the block is
    one ``conv3d_bn_relu`` or ``conv2d_bn_relu`` call: the CUDA kernel on a
    card, its plain version on the CPU, and under ``torch.export`` the
    registered operator that runs them. Train mode runs ``TorchConv`` (the
    kernels with their gradients), then train-mode BatchNorm and ReLU with
    autograd.

    ``remat`` (``remat_policy``: None, "full", "conv" or "dots") recomputes
    part of the train-mode block in the backward instead of keeping its
    activations (``torch.utils.checkpoint``): "full" keeps only the block's
    input and runs the conv kernel again; "conv" keeps the conv's output and
    recomputes BatchNorm and ReLU. "dots" keeps what the JAX policy
    ``checkpoint_dots`` keeps of this block, the convolution's product: the
    conv kernel adds the bias in its epilogue, so that is "conv" here. The
    conv is a ctypes kernel inside an ``autograd.Function``, out of sight of
    a selective-checkpoint policy, so "conv" splits the block at the conv's
    output instead. BatchNorm's running statistics move once, outside the
    recomputed part."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
        init_type: str = "none", generator: Optional[torch.Generator] = None, ndim: int = 3,
        remat: Optional[str] = None,
    ):
        super().__init__()
        if remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat!r}")
        self.dtype, self.remat = dtype, remat
        self.conv = TorchConv(cin, cout, dtype, init_type, generator, ndim)
        self.bn = BatchNorm(cout)

    def _bn_relu(self, y: torch.Tensor):
        y, mean, var = self.bn.train_forward(y)
        return torch.relu(y), mean, var

    def _block(self, x: torch.Tensor):
        return self._bn_relu(self.conv(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.remat is not None:
            if self.remat == "full":
                y, mean, var = checkpoint(self._block, x, use_reentrant=False, preserve_rng_state=False)
            else:  # the conv's output is kept
                y, mean, var = checkpoint(self._bn_relu, self.conv(x), use_reentrant=False, preserve_rng_state=False)
            self.bn.update_running(mean, var, y.numel() // y.shape[-1])
            return y
        if self.training:
            return torch.relu(self.bn(self.conv(x)))
        w, b = fold_batchnorm(
            self.conv.weight, self.conv.bias, self.bn.weight, self.bn.bias,
            self.bn.running_mean, self.bn.running_var, self.bn.eps,
        )
        conv = conv3d_bn_relu if w.dim() == 5 else conv2d_bn_relu
        return conv(x.to(self.dtype).contiguous(), w.to(self.dtype), b)


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
    """MaxPool3d / MaxPool2d(window) with stride = window on NDHWC / NHWC
    (floor output size), by x's rank."""
    n, *spatial, c = x.shape
    out = [s // window for s in spatial]
    x = x[(slice(None), *(slice(0, o * window) for o in out))]
    split = [v for o in out for v in (o, window)]
    return x.reshape(n, *split, c).amax(dim=tuple(range(2, 2 * len(out) + 1, 2)))


def resize_linear_align_corners(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """torch ``interpolate(mode='bilinear' / 'trilinear', align_corners=True)``
    of the spatial axes of NHWC / NDHWC x to ``shape``: output index j samples
    the input at j*(in-1)/(out-1) per axis, as the JAX package's function of
    the same name. In x's dtype (for bf16 PyTorch interpolates in f32 and
    rounds once; the JAX package lerps in bf16)."""
    mode = "bilinear" if x.dim() == 4 else "trilinear"
    y = F.interpolate(x.movedim(-1, 1), size=tuple(int(s) for s in shape), mode=mode, align_corners=True)
    return y.movedim(1, -1)
