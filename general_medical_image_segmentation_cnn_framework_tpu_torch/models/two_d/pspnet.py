"""PSPNet with a dilated ResNet-34 backbone on NHWC slices, as the JAX
package's ``models/two_d/pspnet.py``: a k7 s2 stem with BatchNorm and ReLU,
a 3x3 s2 max pool, basic blocks (3, 4, 6, 3 at 64, 128, 256, 512; the
second stage's first block at stride 2; the third and fourth stages' first
blocks at dilation 1, their others at 2 and 4); the pyramid pooling
module (adaptive average pools to 1, 2, 3 and 6, each a 1x1 conv to 512
resized back bilinearly, concatenated with the features, a 1x1 conv to
1024 and ReLU); three up stages (bilinear x2, k3 p1 conv, BatchNorm,
PReLU) to 256, 64 and 64 with dropout 0.3 / 0.15; a 1x1 head and a log
softmax over the classes in float32, which the train loop's loss takes as
it takes logits.

The stride-1 dilation-1 k3 convs of the basic blocks (14) and the three
up stages' convs run the KD = 1 hand-written kernels, 20 calls a forward;
the stem, the strided and dilated convs and the 1x1 convs are ``F.conv2d``
or a matmul."""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import (
    Dropout, PReLU, ScopeNames, TorchConv, adaptive_avg_pool2d, flax_conv_io, max_pool, resize_linear,
)
from ...nn.norm import BatchNorm
from .unetpp import _BasicBlock, _conv

STAGES = ((64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 1, 2), (512, 3, 1, 4))  # (planes, blocks, stride, dilation)
SIZES = (1, 2, 3, 6)


class _ResNet34Dilated(nn.Module):
    def __init__(self, in_channels, dtype, init_type, gen):
        super().__init__()
        names = ScopeNames()
        self.stem = names(_conv(in_channels, 64, dtype, init_type, gen, k=7, stride=2, p=3))
        self.stem_bn = names(BatchNorm(64))
        self.blocks = nn.ModuleList()
        inplanes = 64
        for planes, blocks, stride, dilation in STAGES:
            for b in range(blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or inplanes != planes)
                self.blocks.append(names(_BasicBlock(inplanes, planes, s, down, dtype, init_type, gen,
                                                     dilation=1 if b == 0 else dilation)))
                inplanes = planes

    def forward(self, x):
        x = max_pool(torch.relu(self.stem_bn(self.stem(x))), 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        return x


class PSPNet(nn.Module):
    def __init__(
        self, in_class: int = 1, n_classes: int = 2, dtype: torch.dtype = torch.float32, init_type: str = "none",
        seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        names = ScopeNames()

        def conv(cin, cout, k=1, p=0, use_bias=True):
            return names(TorchConv(cin, cout, dtype, init_type, gen, ndim=2, kernel_size=k, padding=p,
                                   use_bias=use_bias))

        self.backbone = names(_ResNet34Dilated(in_class, dtype, init_type, gen))
        self.priors = nn.ModuleList(conv(512, 512, use_bias=False) for _ in SIZES)
        self.bottleneck = conv(512 * (len(SIZES) + 1), 1024)
        self.drop = Dropout(0.3, generator=gen)
        self.ups, self.up_bns, self.up_prelus, self.up_drops = (nn.ModuleList() for _ in range(4))
        for cin, cout in ((1024, 256), (256, 64), (64, 64)):
            self.ups.append(conv(cin, cout, k=3, p=1))
            self.up_bns.append(names(BatchNorm(cout)))
            self.up_prelus.append(names(PReLU()))
            self.up_drops.append(Dropout(0.15, generator=gen))
        self.head = conv(64, n_classes)

    @classmethod
    def from_config(cls, config) -> "PSPNet":
        """``PSPNet(in_classes, out_classes)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "PSPNet":
        """A model of the channels of the JAX PSPNet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin = flax_conv_io(params, "_ResNet34Dilated_0", "TorchConv_0")[0]
        return cls(cin, flax_conv_io(params, "TorchConv_8")[1], **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.backbone(x)
        h, w = f.shape[1:3]
        priors = [resize_linear(conv(adaptive_avg_pool2d(f, size)), shape=(h, w))
                  for size, conv in zip(SIZES, self.priors)]
        p = self.drop(torch.relu(self.bottleneck(torch.cat([*priors, f], dim=-1))))
        for conv, bn, prelu, drop in zip(self.ups, self.up_bns, self.up_prelus, self.up_drops):
            p = drop(prelu(bn(conv(resize_linear(p, 2)))))
        return torch.log_softmax(self.head(p).float(), dim=-1)
