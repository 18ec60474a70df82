"""MiniSeg on NHWC slices, as the JAX package's ``models/two_d/miniseg.py``:
four levels (8, 24, 32 and 64 wide, P = 2, 3, 8 and 6 blocks, each level
halving the size) of a long path of ``_DownsamplerBlock``s (1x1 conv, then
a depthwise k5 conv) and a down path (``_ConvBlock``s at level 1,
``_DilatedParallelConvBlock``s after it: four depthwise k3 dilations 1, 2,
4 and 8 with cascaded adds, an average-pool branch, a grouped sigmoid
attention and a grouped 1x1 out), exchanged through a 1x1 conv on their
concatenation split in halves; a decoder of ``_DilatedParallelConvBlockD2``s
with bilinear upsampling (half-pixel centres), and a 1x1 head resized to
the input's size in float32. BatchNorm and per-channel PReLU follow the
convs as in the JAX blocks. The auxiliary heads (``aux=True`` in the JAX
class) are not built: ``from_config`` never asks for them.

Only level 1's two stride-1 ``_ConvBlock``s (8 -> 8, k3 s1 p1) run the KD =
1 hand-written kernels, 2 calls a forward; the strided, grouped, depthwise
and pointwise convs are ``F.conv2d`` or a matmul, as the JAX package runs
them through XLA's conv."""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import Dropout, PReLU, ScopeNames, TorchConv, avg_pool, flax_conv_io, resize_linear
from ...nn.norm import BatchNorm

# (width, P) of the four levels; D = P // 2 of a level's blocks also step the long path
LEVELS = ((8, 2), (24, 3), (32, 8), (64, 6))


def _conv(cin, cout, kw, k=1, stride=1, p=0, d=1, groups=1, use_bias=False):
    return TorchConv(cin, cout, kw["dtype"], kw["init_type"], kw["gen"], ndim=2, kernel_size=k, stride=stride,
                     padding=p, dilation=d, use_bias=use_bias, groups=groups)


class _ConvBlock(nn.Module):
    """Conv k3 (stride, p1, no bias) -> BatchNorm -> PReLU per channel."""

    def __init__(self, cin, cout, stride, kw):
        super().__init__()
        names = ScopeNames()
        self.conv = names(_conv(cin, cout, kw, k=3, stride=stride, p=1))
        self.bn = names(BatchNorm(cout))
        self.prelu = names(PReLU(cout))

    def forward(self, x):
        return self.prelu(self.bn(self.conv(x)))


class _DownsamplerBlock(nn.Module):
    """1x1 conv, depthwise k5 conv (stride, p2) -> BatchNorm -> PReLU."""

    def __init__(self, cin, cout, stride, kw):
        super().__init__()
        names = ScopeNames()
        self.conv1 = names(_conv(cin, cout, kw))
        self.conv2 = names(_conv(cout, cout, kw, k=5, stride=stride, p=2, groups=cout))
        self.bn = names(BatchNorm(cout))
        self.prelu = names(PReLU(cout))

    def forward(self, x):
        return self.prelu(self.bn(self.conv2(self.conv1(x))))


class _DilatedParallelConvBlock(nn.Module):
    """1x1 conv to a quarter of the width; four depthwise k3 convs at
    dilations 1, 2, 4, 8 (stride) and a k3 average pool, added in cascade;
    a grouped (4) 1x1 sigmoid attention that scales each branch by 1 + its
    weight; a grouped (4) 1x1 out -> BatchNorm -> PReLU."""

    def __init__(self, cin, cout, stride, kw):
        super().__init__()
        names = ScopeNames()
        inter = cout // 4
        self.stride = stride
        self.conv1 = names(_conv(cin, inter, kw))
        self.dilated = nn.ModuleList(names(_conv(inter, inter, kw, k=3, stride=stride, p=d, d=d, groups=inter))
                                     for d in (1, 2, 4, 8))
        self.att = names(_conv(4 * inter, 4, kw, groups=4))
        self.out = names(_conv(4 * inter, cout, kw, groups=4))
        self.bn = names(BatchNorm(cout))
        self.prelu = names(PReLU(cout))

    def forward(self, x):
        y = self.conv1(x)
        d = [conv(y) for conv in self.dilated]
        d[0] = d[0] + avg_pool(y, 3, self.stride, 1)
        for i in range(1, 4):
            d[i] = d[i - 1] + d[i]
        att = torch.sigmoid(self.att(torch.cat(d, dim=-1)))
        d = [di + di * att[..., i:i + 1] for i, di in enumerate(d)]
        return self.prelu(self.bn(self.out(torch.cat(d, dim=-1))))


class _DilatedParallelConvBlockD2(nn.Module):
    """1x1 conv; depthwise k3 convs at dilations 1 and 2, added -> BatchNorm."""

    def __init__(self, cin, cout, kw):
        super().__init__()
        names = ScopeNames()
        self.conv1 = names(_conv(cin, cout, kw))
        self.d1 = names(_conv(cout, cout, kw, k=3, p=1, groups=cout))
        self.d2 = names(_conv(cout, cout, kw, k=3, p=2, d=2, groups=cout))
        self.bn = names(BatchNorm(cout))

    def forward(self, x):
        y = self.conv1(x)
        return self.bn(self.d1(y) + self.d2(y))


class MiniSeg(nn.Module):
    def __init__(
        self, in_input: int = 3, classes: int = 2, dtype: torch.dtype = torch.float32, init_type: str = "none",
        seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, init_type=init_type, gen=torch.Generator().manual_seed(seed))
        names = ScopeNames()
        # Flax names each class's modules in the order level() makes them: the level's first long and
        # down blocks, then per block the down block and, for the first P // 2, a long one
        self.levels = nn.ModuleList()
        cin = in_input
        for i, (feats, p) in enumerate(LEVELS):
            down = (lambda ci, s: _ConvBlock(ci, feats, s, kw)) if i == 0 else (
                lambda ci, s: _DilatedParallelConvBlock(ci, feats, s, kw))
            level = nn.Module()
            level.long = names(_DownsamplerBlock(cin, feats, 2, kw))
            level.down = names(down(cin, 2))
            level.blocks, level.longs = nn.ModuleList(), nn.ModuleList()
            for b in range(p):
                level.blocks.append(names(down(feats, 1)))
                if b < p // 2:
                    level.longs.append(names(_DownsamplerBlock(feats, feats, 1, kw)))
            level.cat = names(_conv(2 * feats, 2 * feats, kw))
            level.bn = names(BatchNorm(2 * feats))
            self.levels.append(level)
            cin = feats
        self.up_prelus = nn.ModuleList(names(PReLU(c)) for c in (64, 32, 24, 8))
        self.up4 = names(_conv(64, 64, kw, use_bias=True))
        self.up4_bn = names(BatchNorm(64))
        self.decoders = nn.ModuleList()
        self.skips, self.skip_bns = nn.ModuleList(), nn.ModuleList()
        for cup, c in ((64, 32), (32, 24), (24, 8)):
            self.decoders.append(names(_DilatedParallelConvBlockD2(cup, c, kw)))
            self.skips.append(names(_conv(c, c, kw, use_bias=True)))
            self.skip_bns.append(names(BatchNorm(c)))
        self.drop = Dropout(0.01, generator=kw["gen"])
        self.head = names(_conv(8, classes, kw, use_bias=True))

    @classmethod
    def from_config(cls, config) -> "MiniSeg":
        """``MiniSeg(in_classes, out_classes)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "MiniSeg":
        """A model of the channels of the JAX MiniSeg's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin = flax_conv_io(params, "_ConvBlock_0", "TorchConv_0")[0]
        return cls(cin, flax_conv_io(params, "TorchConv_8")[1], **kwargs)

    @staticmethod
    def _level(level, inp_long, inp_down):
        """(long, out, the exchange's two halves) of one level."""
        long, out = level.long(inp_long), level.down(inp_down)
        out_add = out + long
        longs = iter(level.longs)
        for i, block in enumerate(level.blocks):
            new_out = block(out_add) + out
            if i < len(level.longs):
                long = next(longs)(out_add) + long
            out = new_out
            out_add = out + long
        cat = level.bn(level.cat(torch.cat([long, out], dim=-1)))
        half = cat.shape[-1] // 2
        return long, out, cat[..., :half], cat[..., half:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp_long = inp_down = x
        outs = []
        for level in self.levels:
            long, out, left, right = self._level(level, inp_long, inp_down)
            inp_long, inp_down = left + long, right + out
            outs.append(out)
        up = self.up_prelus[0](self.up4_bn(self.up4(outs[3])))
        for i, (decoder, skip, bn) in enumerate(zip(self.decoders, self.skips, self.skip_bns)):
            up = resize_linear(up, shape=outs[2 - i].shape[1:3])
            up = self.up_prelus[i + 1](decoder(up) + bn(skip(outs[2 - i])))
        z = self.head(self.drop(up))
        return resize_linear(z.float(), shape=x.shape[1:3])
