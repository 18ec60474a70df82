"""UNet++ with a ResNet-34 encoder on NHWC slices, as the JAX package's
``models/two_d/unetpp.py``: a k7 s2 stem with BatchNorm and ReLU (``x0_0``),
a 3x3 s2 max pool, ResNet-34's four stages of basic blocks (3, 4, 6, 3 at
64, 128, 256, 512; the first block of the last three strided, with a 1x1
projection shortcut), the nested decoder grid ``x_{i,j}`` of ten decoder
blocks (three conv -> BatchNorm -> ReLU each, on the concatenation of the
row's earlier nodes and the nearest-upsampled node below), four 1x1 heads
blended by the learnt ``mix`` (``mix[0]`` is never read, as in the JAX
model) in float32, and a bilinear resize (half-pixel centres) to the
input's size.

The basic blocks' stride-1 k3 convs and the decoder blocks' convs (k3 s1
p1) run the KD = 1 instances of the hand-written kernels, 59 calls a
forward; the stem, the strided convs and the projections are
``F.conv2d``."""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import ScopeNames, TorchConv, flax_conv_io, max_pool, resize_linear, resize_nearest
from ...nn.norm import BatchNorm

STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))  # (planes, blocks, stride)
# the decoder nodes in call order: (i, j) of x_{i,j}, its Cin, its width
DECODER = (((0, 1), 128, 64), ((1, 1), 192, 64), ((0, 2), 192, 64), ((2, 1), 384, 128), ((1, 2), 256, 128),
           ((0, 3), 320, 128), ((3, 1), 768, 256), ((2, 2), 512, 256), ((1, 3), 512, 256), ((0, 4), 576, 256))


def _conv(cin, cout, dtype, init_type, gen, k=3, stride=1, p=1, d=1):
    return TorchConv(cin, cout, dtype, init_type, gen, ndim=2, kernel_size=k, stride=stride, padding=p,
                     dilation=d, use_bias=False)


class _BasicBlock(nn.Module):
    """ResNet's basic block: conv -> BatchNorm -> ReLU -> conv -> BatchNorm,
    plus x or its 1x1 projection (conv -> BatchNorm), then ReLU. Both k3
    convs are padded by their ``dilation`` (PSPNet's dilated stages)."""

    def __init__(self, inplanes, planes, stride, downsample, dtype, init_type, gen, dilation=1):
        super().__init__()
        names = ScopeNames()
        self.conv1 = names(_conv(inplanes, planes, dtype, init_type, gen, stride=stride, p=dilation, d=dilation))
        self.bn1 = names(BatchNorm(planes))
        self.conv2 = names(_conv(planes, planes, dtype, init_type, gen, p=dilation, d=dilation))
        self.bn2 = names(BatchNorm(planes))
        self.down = self.down_bn = None
        if downsample:
            self.down = names(_conv(inplanes, planes, dtype, init_type, gen, k=1, stride=stride, p=0))
            self.down_bn = names(BatchNorm(planes))

    def forward(self, x):
        out = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        residual = x if self.down is None else self.down_bn(self.down(x))
        return torch.relu(out + residual)


class _DecoderBlock(nn.Module):
    """Three conv -> BatchNorm -> ReLU on the concatenated inputs, to half
    the width, half, and the width."""

    def __init__(self, cin, out_channels, dtype, init_type, gen):
        super().__init__()
        names = ScopeNames()
        half = out_channels // 2
        self.convs = nn.ModuleList(names(_conv(ci, co, dtype, init_type, gen))
                                   for ci, co in ((cin, half), (half, half), (half, out_channels)))
        self.bns = nn.ModuleList(names(BatchNorm(co)) for co in (half, half, out_channels))

    def forward(self, xs):
        x = torch.cat(xs, dim=-1)
        for conv, bn in zip(self.convs, self.bns):
            x = torch.relu(bn(conv(x)))
        return x


class UNetPlusPlus(nn.Module):
    def __init__(
        self, num_channels: int = 1, num_class: int = 2, dtype: torch.dtype = torch.float32, init_type: str = "none",
        seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, init_type=init_type, gen=gen)
        names = ScopeNames()
        self.stem = names(_conv(num_channels, 64, k=7, stride=2, p=3, **kw))
        self.stem_bn = names(BatchNorm(64))
        self.stages = nn.ModuleList()
        inplanes = 64
        for planes, blocks, stride in STAGES:
            stage = nn.ModuleList()
            for b in range(blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or inplanes != planes)
                stage.append(names(_BasicBlock(inplanes, planes, s, down, dtype, init_type, gen)))
                inplanes = planes
            self.stages.append(stage)
        self.decoders = nn.ModuleList(names(_DecoderBlock(cin, out, dtype, init_type, gen)) for _, cin, out in DECODER)
        self.heads = nn.ModuleList(
            names(TorchConv(c, num_class, dtype, init_type, gen, ndim=2, kernel_size=1, padding=0))
            for c in (64, 64, 128, 256)
        )
        self.mix = nn.Parameter(torch.ones(5))
        self.flax_params = ("mix",)  # read from the model's own Flax scope by convert.py

    @classmethod
    def from_config(cls, config) -> "UNetPlusPlus":
        """``UNetPlusPlus(in_classes, out_classes)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "UNetPlusPlus":
        """A model of the channels of the JAX UNetPlusPlus's params tree;
        ``kwargs`` (``dtype``, ...) go to the constructor."""
        return cls(flax_conv_io(params, "TorchConv_0")[0], flax_conv_io(params, "TorchConv_1")[1], **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        nodes = {(0, 0): torch.relu(self.stem_bn(self.stem(x)))}
        y = max_pool(nodes[(0, 0)], 3, 2, 1)
        for i, stage in enumerate(self.stages, start=1):
            for block in stage:
                y = block(y)
            nodes[(i, 0)] = y
        for ((i, j), _, _), decoder in zip(DECODER, self.decoders):
            nodes[(i, j)] = decoder([*(nodes[(i, k)] for k in range(j)), resize_nearest(nodes[(i + 1, j - 1)])])
        logits = [head(nodes[(0, j)]) for j, head in enumerate(self.heads, start=1)]
        logit = sum(self.mix[j] * z.to(torch.promote_types(z.dtype, self.mix.dtype))
                    for j, z in enumerate(logits, start=1))
        return resize_linear(logit.float(), shape=(h, w))
