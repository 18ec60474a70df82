"""DeepLabV3 with a dilated ResNet-101 backbone on NHWC slices, as the JAX
package's ``models/two_d/deeplab.py``: a deep stem (k3 s2 conv to 64, k3
convs to 64 and 128, each with BatchNorm and ReLU), a 3x3 s2 max pool,
bottleneck blocks (``layers`` 3, 4, 23, 3 at 64, 128, 256, 512 x 4;
``dilation`` 1, 1, 1, 2: a stage strides 2 in its first block unless it
is the first or dilated), ASPP (a 1x1 branch and k3 branches at rates 6,
12 and 18 to 256, BatchNorm and leaky ReLU over their concatenation, a
1x1 to 256; plus a global-mean branch of 1x1, BatchNorm, leaky ReLU and
1x1, tiled back; BatchNorm and leaky ReLU over the sum), a 1x1 classifier
and a bilinear resize with aligned corners to the input's size, in
float32.

The stem's second and third convs and the bottlenecks' k3 convs at stride
1 and dilation 1 (3 + 3 + 22 in the first three stages) run the KD = 1
hand-written kernels, 30 calls a forward; the strided and dilated convs
(the fourth stage, ASPP's rates) and the 1x1 convs are ``F.conv2d`` or a
matmul."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.blocks import ScopeNames, TorchConv, flax_conv_io, max_pool, resize_linear_align_corners
from ...nn.norm import BatchNorm


def _conv(cin, cout, dtype, init_type, gen, k=1, stride=1, p=0, d=1, use_bias=False):
    return TorchConv(cin, cout, dtype, init_type, gen, ndim=2, kernel_size=k, stride=stride, padding=p,
                     dilation=d, use_bias=use_bias)


def _leaky_relu(x):
    return F.leaky_relu(x, 0.01)


class _Bottleneck(nn.Module):
    """1x1 -> k3 (stride, dilation) -> 1x1 to 4 x planes, each with
    BatchNorm (ReLU after the first two), plus x or its strided 1x1
    projection with BatchNorm, then ReLU."""

    def __init__(self, inplanes, planes, stride, dilation, downsample, dtype, init_type, gen):
        super().__init__()
        names = ScopeNames()
        self.conv1 = names(_conv(inplanes, planes, dtype, init_type, gen))
        self.bn1 = names(BatchNorm(planes))
        self.conv2 = names(_conv(planes, planes, dtype, init_type, gen, k=3, stride=stride, p=dilation, d=dilation))
        self.bn2 = names(BatchNorm(planes))
        self.conv3 = names(_conv(planes, 4 * planes, dtype, init_type, gen))
        self.bn3 = names(BatchNorm(4 * planes))
        self.down = self.down_bn = None
        if downsample:
            self.down = names(_conv(inplanes, 4 * planes, dtype, init_type, gen, stride=stride))
            self.down_bn = names(BatchNorm(4 * planes))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn3(self.conv3(torch.relu(self.bn2(self.conv2(out)))))
        residual = x if self.down is None else self.down_bn(self.down(x))
        return torch.relu(out + residual)


class ResNetBackbone(nn.Module):
    """The deep-stem dilated ResNet; ``layers`` and ``dilation`` as the JAX
    ``ResNetBackbone`` takes them."""

    def __init__(
        self, in_channels: int = 1, layers: Sequence[int] = (3, 4, 23, 3), dilation: Sequence[int] = (1, 1, 1, 2),
        dtype: torch.dtype = torch.float32, init_type: str = "none", gen=None,
    ):
        super().__init__()
        names = ScopeNames()
        self.stem = nn.ModuleList(names(_conv(ci, co, dtype, init_type, gen, k=3, stride=s, p=1))
                                  for ci, co, s in ((in_channels, 64, 2), (64, 64, 1), (64, 128, 1)))
        self.stem_bns = nn.ModuleList(names(BatchNorm(c)) for c in (64, 64, 128))
        self.blocks = nn.ModuleList()
        inplanes = 128
        for i, (blocks, dil) in enumerate(zip(layers, dilation)):
            planes = 64 * 2**i
            stride = 1 if (i == 0 or dil != 1) else 2
            for b in range(blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or inplanes != 4 * planes)
                self.blocks.append(names(_Bottleneck(inplanes, planes, s, dil, down, dtype, init_type, gen)))
                inplanes = 4 * planes

    def forward(self, x):
        for conv, bn in zip(self.stem, self.stem_bns):
            x = torch.relu(bn(conv(x)))
        x = max_pool(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        return x


class ASPP(nn.Module):
    def __init__(self, cin, dtype, init_type, gen, out_channels=256, dilation_rates=(6, 12, 18), hidden=256):
        super().__init__()
        names = ScopeNames()
        self.branches = nn.ModuleList([names(_conv(cin, hidden, dtype, init_type, gen))] + [
            names(_conv(cin, hidden, dtype, init_type, gen, k=3, p=r, d=r)) for r in dilation_rates])
        self.bn = names(BatchNorm(hidden * (len(dilation_rates) + 1)))
        self.out = names(_conv(hidden * (len(dilation_rates) + 1), out_channels, dtype, init_type, gen))
        self.pool1 = names(_conv(cin, hidden, dtype, init_type, gen))
        self.pool_bn = names(BatchNorm(hidden))
        self.pool2 = names(_conv(hidden, out_channels, dtype, init_type, gen))
        self.final_bn = names(BatchNorm(out_channels))

    def forward(self, x):
        out = _leaky_relu(self.bn(torch.cat([branch(x) for branch in self.branches], dim=-1)))
        out = self.out(out)
        pool = self.pool2(_leaky_relu(self.pool_bn(self.pool1(x.mean(dim=(1, 2), keepdim=True)))))
        return _leaky_relu(self.final_bn(out + pool))  # the [B, 1, 1, C] pool broadcasts as the JAX tile


class DeepLabV3(nn.Module):
    def __init__(
        self, in_class: int = 1, class_num: int = 2, dtype: torch.dtype = torch.float32, init_type: str = "none",
        seed: int = 0, layers: Sequence[int] = (3, 4, 23, 3), dilation: Sequence[int] = (1, 1, 1, 2),
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        names = ScopeNames()
        self.backbone = names(ResNetBackbone(in_class, layers, dilation, dtype, init_type, gen))
        self.aspp = names(ASPP(64 * 2 ** (len(layers) - 1) * 4, dtype, init_type, gen))
        self.classifier = names(_conv(256, class_num, dtype, init_type, gen, use_bias=True))

    @classmethod
    def from_config(cls, config) -> "DeepLabV3":
        """``DeepLabV3(in_classes, out_classes)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "DeepLabV3":
        """A model of the channels and depth of the JAX DeepLabV3's params
        tree (its bottlenecks counted by stage width); ``kwargs`` (``dtype``,
        ...) go to the constructor. A tree of a backbone with other
        ``dilation`` needs it in ``kwargs``."""
        backbone = params["ResNetBackbone_0"]
        widths = [flax_conv_io(backbone, f"_Bottleneck_{i}", "TorchConv_0")[1]
                  for i in range(sum(k.startswith("_Bottleneck_") for k in backbone))]
        kwargs.setdefault("layers", tuple(widths.count(64 * 2**i) for i in range(4)))
        cin = flax_conv_io(backbone, "TorchConv_0")[0]
        return cls(cin, flax_conv_io(params, "TorchConv_0")[1], **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pred = self.classifier(self.aspp(self.backbone(x)))
        return resize_linear_align_corners(pred.float(), x.shape[1:3])
