"""Residual 3-D U-Net (Isensee 2017-style context / localization network),
channels-last, as the JAX package's ``models/three_d/residual_unet3d.py``:
InstanceNorm + LeakyReLU(0.01) everywhere, Dropout(0.6), strided k3 s2
convs down, nearest upsampling + conv up, residual context blocks, and
deep supervision by two 1x1x1 heads summed after upsampling. Every conv is
bias-free.

As in the JAX model, each context level applies ONE ``_NormLReluConv``
twice (one set of weights, two uses), and level 1 takes its skip before
the instance norm. The k3 s1 p1 convs (19 calls a forward: the stem, two
at level 1, the shared convs twice at four levels, four upscale convs and
four localization convs) run the hand-written kernels; the k3 s2 downs
are ``F.conv3d`` and the k1 convs matmuls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.blocks import Dropout, ScopeNames, TorchConv, flax_conv_io, resize_nearest
from ...nn.norm import InstanceNorm


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


def _conv(cin, cout, dtype, init_type, gen, stride=1, k=3, p=1):
    return TorchConv(cin, cout, dtype, init_type, gen, kernel_size=k, stride=stride, padding=p, use_bias=False)


class _NormLReluConv(nn.Module):
    def __init__(self, cin, cout, dtype, init_type, gen):
        super().__init__()
        self.norm = InstanceNorm(dtype=dtype)
        self.conv = _conv(cin, cout, dtype, init_type, gen)
        self.conv.scope = "TorchConv_0"

    def forward(self, x):
        return self.conv(_lrelu(self.norm(x)))


class _ConvNormLRelu(nn.Module):
    def __init__(self, cin, cout, dtype, init_type, gen):
        super().__init__()
        self.conv = _conv(cin, cout, dtype, init_type, gen)
        self.conv.scope = "TorchConv_0"
        self.norm = InstanceNorm(dtype=dtype)

    def forward(self, x):
        return _lrelu(self.norm(self.conv(x)))


class _NormLReluUpscaleConvNormLRelu(nn.Module):
    def __init__(self, cin, cout, dtype, init_type, gen):
        super().__init__()
        self.norm1 = InstanceNorm(dtype=dtype)
        self.conv = _conv(cin, cout, dtype, init_type, gen)
        self.conv.scope = "TorchConv_0"
        self.norm2 = InstanceNorm(dtype=dtype)

    def forward(self, x):
        y = resize_nearest(_lrelu(self.norm1(x)), 2)
        return _lrelu(self.norm2(self.conv(y)))


class ResidualUNet3D(nn.Module):
    def __init__(
        self, in_channels: int = 1, n_classes: int = 2, base_n_filter: int = 32, dropout_rate: float = 0.6,
        dtype: torch.dtype = torch.float32, init_type: str = "none", seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        f = base_n_filter
        kw = dict(dtype=dtype, init_type=init_type, gen=gen)
        convs, names = ScopeNames(), ScopeNames()

        def c(cin, cout, **extra):
            return convs(_conv(cin, cout, dtype, init_type, gen, **extra))

        # TorchConv_0..13 in the JAX model's call order
        self.conv1, self.conv2, self.conv3 = c(in_channels, f), c(f, f), c(f, f)
        self.downs = nn.ModuleList(c(f * 2**i, f * 2 ** (i + 1), stride=2) for i in range(4))
        self.drop = Dropout(dropout_rate, generator=gen)
        self.norm1 = InstanceNorm(dtype=dtype)
        self.context_norms = nn.ModuleList(InstanceNorm(dtype=dtype) for _ in range(3))
        self.shared = nn.ModuleList(
            names(_NormLReluConv(f * 2 ** (i + 1), f * 2 ** (i + 1), **kw)) for i in range(4)
        )
        self.ups = nn.ModuleList(
            names(_NormLReluUpscaleConvNormLRelu(f * 2 ** (4 - i), f * 2 ** (3 - i), **kw)) for i in range(4)
        )
        self.bottom_k1 = c(8 * f, 8 * f, k=1, p=0)
        self.bottom_norm = InstanceNorm(dtype=dtype)
        # the localization path: (ConvNormLRelu, k1 conv) at 16f, 8f, 4f; then 2f with the head
        self.locs = nn.ModuleList(names(_ConvNormLRelu(f * 2 ** (4 - i), f * 2 ** (4 - i), **kw)) for i in range(4))
        self.loc_k1 = nn.ModuleList(c(f * 2 ** (4 - i), f * 2 ** (3 - i), k=1, p=0) for i in range(3))
        self.out_pred = c(2 * f, n_classes, k=1, p=0)
        self.ds2 = c(8 * f, n_classes, k=1, p=0)
        self.ds3 = c(4 * f, n_classes, k=1, p=0)

    @classmethod
    def from_config(cls, config) -> "ResidualUNet3D":
        """``ResidualUNet3D(in_classes, out_classes, base_n_filter=32)``, the
        JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, 32, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "ResidualUNet3D":
        """A model of the widths of the JAX ResidualUNet3D's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin, f = flax_conv_io(params, "TorchConv_0")
        return cls(cin, flax_conv_io(params, "TorchConv_11")[1], f, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        residual_1 = out
        out = self.conv2(_lrelu(out))
        out = self.conv3(_lrelu(self.drop(out)))
        out = out + residual_1
        context_1 = _lrelu(out)  # the skip is taken before the norm
        out = _lrelu(self.norm1(out))
        contexts = []
        for level in range(4):
            out = self.downs[level](out)
            residual = out
            out = self.shared[level](self.drop(self.shared[level](out)))
            out = out + residual
            if level < 3:
                out = _lrelu(self.context_norms[level](out))
                contexts.append(out)
        out = self.ups[0](out)
        out = _lrelu(self.bottom_norm(self.bottom_k1(out)))
        ds = []
        for i, skip in enumerate(reversed(contexts)):  # context_4, 3, 2
            out = self.locs[i](torch.cat([out, skip], dim=-1))
            if i > 0:
                ds.append(out)
            out = self.ups[i + 1](self.loc_k1[i](out))
        out = self.locs[3](torch.cat([out, context_1], dim=-1))
        out_pred = self.out_pred(out)
        ds2_up = resize_nearest(self.ds2(ds[0]), 2)
        ds_sum_up = resize_nearest(ds2_up + self.ds3(ds[1]), 2)
        return (out_pred + ds_sum_up).float()
