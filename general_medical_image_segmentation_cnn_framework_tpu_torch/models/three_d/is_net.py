"""IS-Net: a U-Net with one shared encoder and three decoders, for
integration / separation learning, channels-last, as the JAX package's
``models/three_d/is_net.py``. ``forward(x, low, high)``: the ONE encoder
runs on x and on its FFT low- and high-pass bands (``ops.fft.band_split``,
computed by ``models.make_forward`` as the JAX drivers do), each through
its own decoder; ``out1 = head1(dec)``, ``out2 = head2(dec + dec_low +
dec_high)``; returns (out1, out2), and the drivers train and predict on
out1. In train mode the encoder's BatchNorm running statistics move three
times a forward, in that order (x, low, high). ``forward(x)`` without the
bands gives (out1, None): the encoder on x and the first decoder alone,
which is all of the graph that the JAX predict keeps of its jitted
forward (XLA drops the rest, whose output nothing reads); predict and
serve take it.

Every conv of the encoder and the decoders is a ConvBlock (k3 s1 p1: the
hand-written kernels), 54 calls a forward with the bands, 18 without.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn.blocks import ConvBlock, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io, max_pool
from ...nn.blocks import remat_policy as block_remat


class _Encoder(nn.Module):
    """(enc1, enc2, enc3, enc4, bottleneck): ConvBlock pairs at f, 2f, 4f,
    8f, 16f with 2x max-pool downs."""

    def __init__(self, cin, f, dtype, init_type, gen, remat):
        super().__init__()
        names = ScopeNames()
        widths = [(cin, f), (f, f), (f, 2 * f), (2 * f, 2 * f), (2 * f, 4 * f), (4 * f, 4 * f),
                  (4 * f, 8 * f), (8 * f, 8 * f), (8 * f, 16 * f), (16 * f, 16 * f)]
        self.blocks = nn.ModuleList(names(ConvBlock(ci, co, dtype, init_type, gen, remat=remat)) for ci, co in widths)

    def forward(self, x):
        b, out = self.blocks, []
        for i in range(5):
            x = b[2 * i + 1](b[2 * i](max_pool(x) if i else x))
            out.append(x)
        return out


class _Decoder(nn.Module):
    """dec1 from the encoder's five outputs: four k2 s2 up-convs, each
    concatenated with its skip, then a ConvBlock pair."""

    def __init__(self, f, dtype, init_type, gen, remat):
        super().__init__()
        ups, blocks = ScopeNames(), ScopeNames()
        self.ups = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for c in (8 * f, 4 * f, 2 * f, f):
            self.ups.append(ups(TorchConvTranspose(2 * c, c, dtype, init_type, gen)))
            self.blocks.append(blocks(ConvBlock(2 * c, c, dtype, init_type, gen, remat=remat)))
            self.blocks.append(blocks(ConvBlock(c, c, dtype, init_type, gen, remat=remat)))

    def forward(self, skips):
        *skips, y = skips
        for i, skip in enumerate(reversed(skips)):
            y = torch.cat([self.ups[i](y), skip], dim=-1)
            y = self.blocks[2 * i + 1](self.blocks[2 * i](y))
        return y


class ISNet(nn.Module):
    def __init__(
        self, in_channels: int = 1, out_channels: int = 2, init_features: int = 32,
        dtype: torch.dtype = torch.float32, init_type: str = "none", seed: int = 0,
        remat: bool = False, remat_policy: str = "",
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        f = init_features
        policy = block_remat(remat_policy) if remat else None
        self.encoder = _Encoder(in_channels, f, dtype, init_type, gen, policy)
        self.encoder.scope = "_Encoder_0"
        decoders, convs = ScopeNames(), ScopeNames()
        self.decoders = nn.ModuleList(decoders(_Decoder(f, dtype, init_type, gen, policy)) for _ in range(3))
        self.head1 = convs(TorchConv(f, out_channels, dtype, init_type, gen, kernel_size=1))
        self.head2 = convs(TorchConv(f, out_channels, dtype, init_type, gen, kernel_size=1))

    @classmethod
    def from_config(cls, config) -> "ISNet":
        """``ISNet(in_classes, out_classes, init_features=32)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, 32, **model_kwargs(config, remat=True))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "ISNet":
        """A model of the widths of the JAX ISNet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin, f = flax_conv_io(params, "_Encoder_0", "ConvBlock_0", "TorchConv_0")
        return cls(cin, flax_conv_io(params, "TorchConv_0")[1], f, **kwargs)

    def forward(self, x: torch.Tensor, low_x: Optional[torch.Tensor] = None, high_x: Optional[torch.Tensor] = None):
        """(out1, out2) of x and its FFT bands; (out1, None) without them."""
        dec = self.decoders[0](self.encoder(x))
        out1 = self.head1(dec).float()
        if low_x is None and high_x is None:
            return out1, None
        dec_low, dec_high = (decoder(self.encoder(z)) for decoder, z in zip(self.decoders[1:], (low_x, high_x)))
        return out1, self.head2(dec + dec_low + dec_high).float()
