"""HighResNet's building blocks and the squeeze-excite blocks, channels-last,
as the JAX package's ``nn/residual.py``: ``pad_spatial`` (constant,
reflect or replicate), the pre- or post-activation ``ConvolutionalBlock``
with dilation, ``ResidualBlock`` (identity, zero-channel 'pad' or 1x1
'project' shortcut), ``DilationBlock``, ``SEInception`` and ``SEResidual``.
Rank-generic (NDHWC or NHWC); each module's ``scope`` children follow the
JAX modules' Flax names, so ``convert.py`` maps their variables.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Dense, ScopeNames, TorchConv, _generator, global_avg_pool
from .norm import BatchNorm, InstanceNorm

_PAD_MODES = {"constant": "constant", "reflect": "reflect", "replicate": "replicate"}


def pad_spatial(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad every spatial axis of NDHWC / NHWC x by ``pad`` on both sides:
    zeros ('constant'), mirrored without the edge ('reflect') or the edge
    repeated ('replicate')."""
    if pad == 0:
        return x
    nd = x.dim() - 2
    if mode == "constant":
        return F.pad(x, (0, 0) + (pad, pad) * nd)
    y = F.pad(x.movedim(-1, 1), (pad, pad) * nd, mode=_PAD_MODES[mode])
    return y.movedim(1, -1)


class ConvolutionalBlock(nn.Module):
    """(pre | post)-activation Norm / ReLU / Conv with explicit padding: the
    input padded by ``dilation`` in ``padding_mode``, then a k-``kernel_size``
    conv with no padding at that dilation, without a bias when a norm
    follows or precedes it. With constant padding the pad is the conv's own
    zero padding, so a k3 dilation-1 block is the k3 s1 p1 conv (the
    hand-written kernel) and a dilated one ``F.conv3d`` with padding =
    dilation; reflect and replicate pad first."""

    def __init__(
        self, cin: int, cout: int, dilation: int = 1, batch_norm: bool = True,
        instance_norm: bool = False, norm_affine: bool = True, padding_mode: str = "constant",
        preactivation: bool = True, kernel_size: int = 3, activation: bool = True,
        init_type: str = "none", dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None, ndim: int = 3,
    ):
        super().__init__()
        if batch_norm and instance_norm:
            raise ValueError("ConvolutionalBlock: batch_norm and instance_norm are exclusive")
        if padding_mode not in _PAD_MODES:
            raise KeyError(f"unknown padding_mode {padding_mode!r}")
        self.preactivation, self.activation, self.dtype = preactivation, activation, dtype
        self.pad = dilation if kernel_size > 1 else 0
        self.padding_mode = padding_mode
        norm_channels = cin if preactivation else cout
        self.norm = None
        if batch_norm:
            self.norm = BatchNorm(norm_channels)
            self.norm.scope = "BatchNorm_0"
        elif instance_norm:
            self.norm = InstanceNorm(norm_channels, affine=norm_affine, dtype=dtype)
            self.norm.scope = "InstanceNorm_0"
        own_pad = self.pad if padding_mode == "constant" else 0
        self.conv = TorchConv(
            cin, cout, dtype, init_type, generator, ndim, kernel_size, padding=own_pad, dilation=dilation,
            use_bias=not (batch_norm or instance_norm),
        )
        self.conv.scope = "TorchConv_0"

    def _norm_act(self, y: torch.Tensor) -> torch.Tensor:
        if self.norm is not None:
            y = self.norm(y).to(self.dtype)
        return torch.relu(y) if self.activation else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._norm_act(x) if self.preactivation else x
        if self.padding_mode != "constant":
            y = pad_spatial(y, self.pad, self.padding_mode)
        y = self.conv(y)
        return y if self.preactivation else self._norm_act(y)


class ResidualBlock(nn.Module):
    """``num_layers`` ConvolutionalBlocks plus a shortcut: the identity, or
    where the channels change zero channels split half before and half
    after x ('pad') or a bias-free 1x1 conv ('project')."""

    def __init__(
        self, cin: int, cout: int, num_layers: int = 2, dilation: int = 1, batch_norm: bool = True,
        instance_norm: bool = False, residual: bool = True, residual_type: str = "pad",
        padding_mode: str = "constant", init_type: str = "none", dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None, ndim: int = 3,
    ):
        super().__init__()
        if residual_type not in ("pad", "project"):
            raise ValueError(f"unknown residual_type {residual_type!r}")
        names = ScopeNames()
        gen = _generator(generator)
        self.layers = nn.ModuleList(
            names(ConvolutionalBlock(
                cin if i == 0 else cout, cout, dilation, batch_norm, instance_norm,
                padding_mode=padding_mode, init_type=init_type, dtype=dtype, generator=gen, ndim=ndim,
            ))
            for i in range(num_layers)
        )
        self.residual, self.residual_type, self.cin, self.cout = residual, residual_type, cin, cout
        if residual and cin != cout and residual_type == "project":
            self.project = names(TorchConv(cin, cout, dtype, init_type, gen, ndim, 1, use_bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for layer in self.layers:
            out = layer(out)
        if not self.residual:
            return out
        shortcut = x
        if self.cin != self.cout:
            if self.residual_type == "project":
                shortcut = self.project(x)
            else:
                diff = self.cout - self.cin
                half = diff // 2
                shortcut = F.pad(x, (half, diff - half))
        return shortcut + out


class DilationBlock(nn.Module):
    """``num_residual_blocks`` ResidualBlocks at one dilation."""

    def __init__(
        self, cin: int, cout: int, dilation: int = 1, layers_per_block: int = 2,
        num_residual_blocks: int = 3, batch_norm: bool = True, instance_norm: bool = False,
        residual: bool = True, padding_mode: str = "constant", init_type: str = "none",
        dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None, ndim: int = 3,
    ):
        super().__init__()
        names = ScopeNames()
        gen = _generator(generator)
        self.blocks = nn.ModuleList(
            names(ResidualBlock(
                cin if i == 0 else cout, cout, layers_per_block, dilation, batch_norm, instance_norm,
                residual, padding_mode=padding_mode, init_type=init_type, dtype=dtype, generator=gen, ndim=ndim,
            ))
            for i in range(num_residual_blocks)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class _SqueezeExcite(nn.Module):
    """sigmoid(Dense(relu(Dense(GAP(x))))), the Dense layers bias-free,
    [C -> max(C // reduction, 1) -> C]."""

    def __init__(self, channels: int, reduction: int = 16, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        names, gen = ScopeNames(), _generator(generator)
        hidden = max(channels // reduction, 1)
        self.fc1 = names(Dense(channels, hidden, dtype, gen, use_bias=False))
        self.fc2 = names(Dense(hidden, channels, dtype, gen, use_bias=False))

    def scale(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(global_avg_pool(x)))))


class SEInception(_SqueezeExcite):
    """Squeeze-excite: x * scale."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale(x)


class SEResidual(_SqueezeExcite):
    """Squeeze-excite with a residual: x + x * scale."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + x * self.scale(x)
