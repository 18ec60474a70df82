"""3-D Skip-DenseNet (Bui et al., 3D-SkipDenseSeg), channels-last, as the
JAX package's ``models/three_d/densenet3d.py``: a stem of three k3 convs
(conv -> BatchNorm -> ReLU twice, then a conv whose output is the skip),
BatchNorm -> ReLU -> a k2 s2 conv down, four dense blocks of four
bottleneck layers (BatchNorm -> ReLU -> 1x1 conv to 64 -> BatchNorm ->
ReLU -> k3 conv to 16 -> Dropout(0.1), concatenated to the layer's input)
with transitions (BatchNorm -> ReLU -> 1x1 conv to half, BatchNorm -> ReLU
-> k2 s2 conv) between them, after each block a transposed conv grouped by
class (kernel 2^(i+1) + 2, stride 2^(i+1), padding 1) back to the input's
size, and BatchNorm -> ReLU -> 1x1 head over the four heads and the skip.

The JAX ``from_config`` passes no ``init_type``, so its default, kaiming,
always holds (the reference's constructor forces it); ``from_config``
here does the same. The stem's 3 convs and the 16 dense-layer k3 convs
(k3 s1 p1) run the hand-written kernels, 19 calls a forward.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...nn.blocks import Dropout, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io
from ...nn.norm import BatchNorm


class _GroupedConvTranspose(TorchConvTranspose):
    """The JAX package's ``_GroupedConvTranspose``: one bias-free
    ``TorchConvTranspose`` a group (its scope's ``TorchConvTranspose_{g}``),
    here one grouped transposed conv whose weight holds the groups' kernels
    concatenated along Cin."""

    def __init__(self, cin, cout, groups, kernel_size, stride, padding, dtype, init_type, gen):
        super().__init__(cin, cout, dtype, init_type, gen, kernel_size=kernel_size, stride=stride, padding=padding,
                         groups=groups, use_bias=False)


class _DenseLayer(nn.Module):
    """BatchNorm -> ReLU -> 1x1 conv -> BatchNorm -> ReLU -> k3 conv ->
    Dropout, concatenated to x (every conv bias-free)."""

    def __init__(self, cin, growth, bn_size, drop_rate, dtype, init_type, gen):
        super().__init__()
        names = ScopeNames()
        kw = dict(dtype=dtype, init_type=init_type, generator=gen, use_bias=False)
        self.bn1 = names(BatchNorm(cin))
        self.conv1 = names(TorchConv(cin, bn_size * growth, kernel_size=1, padding=0, **kw))
        self.bn2 = names(BatchNorm(bn_size * growth))
        self.conv2 = names(TorchConv(bn_size * growth, growth, kernel_size=3, padding=1, **kw))
        self.dropout = Dropout(drop_rate, generator=gen)

    def forward(self, x):
        y = self.conv1(torch.relu(self.bn1(x)))
        y = self.conv2(torch.relu(self.bn2(y)))
        return torch.cat([x, self.dropout(y)], dim=-1)


class SkipDenseNet3D(nn.Module):
    def __init__(
        self, in_channels: int = 1, classes: int = 2, growth_rate: int = 16,
        block_config: Sequence[int] = (4, 4, 4, 4), num_init_features: int = 32, drop_rate: float = 0.1,
        bn_size: int = 4, dtype: torch.dtype = torch.float32, init_type: str = "kaiming", seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, init_type=init_type, generator=gen)
        f = num_init_features
        names = ScopeNames()
        self.stem_convs = nn.ModuleList()
        self.stem_bns = nn.ModuleList()
        for cin in (in_channels, f, f):
            self.stem_convs.append(names(TorchConv(cin, f, kernel_size=3, padding=1, use_bias=False, **kw)))
            self.stem_bns.append(names(BatchNorm(f)))
        self.down = names(TorchConv(f, f, kernel_size=2, stride=2, padding=0, use_bias=False, **kw))
        self.blocks = nn.ModuleList()
        self.ups = nn.ModuleList()
        self.transitions = nn.ModuleList()
        c = f
        for i, num_layers in enumerate(block_config):
            layers = nn.ModuleList()
            for _ in range(num_layers):
                layers.append(names(_DenseLayer(c, growth_rate, bn_size, drop_rate, dtype, init_type, gen)))
                c += growth_rate
            self.blocks.append(layers)
            s = 2 ** (i + 1)
            self.ups.append(names(_GroupedConvTranspose(c, classes, classes, s + 2, s, 1, dtype, init_type, gen)))
            if i != len(block_config) - 1:
                self.transitions.append(nn.ModuleList([
                    names(BatchNorm(c)), names(TorchConv(c, c // 2, kernel_size=1, padding=0, use_bias=False, **kw)),
                    names(BatchNorm(c // 2)), names(TorchConv(c // 2, c // 2, kernel_size=2, stride=2, padding=0, **kw)),
                ]))
                c //= 2
        self.head_bn = names(BatchNorm(len(block_config) * classes + f))
        self.head = names(TorchConv(len(block_config) * classes + f, classes, kernel_size=1, padding=0, **kw))

    @classmethod
    def from_config(cls, config) -> "SkipDenseNet3D":
        """``SkipDenseNet3D(in_classes, out_classes)`` with the dataclass
        defaults, the JAX ``from_config``: kaiming init whatever
        ``config.init_type`` says."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **{**model_kwargs(config), "init_type": "kaiming"})

    @classmethod
    def from_flax(cls, params, **kwargs) -> "SkipDenseNet3D":
        """A model of the channels of the JAX SkipDenseNet3D's params tree;
        ``kwargs`` (``dtype``, ...) go to the constructor."""
        return cls(flax_conv_io(params, "TorchConv_0")[0], flax_conv_io(params, "TorchConv_10")[1], **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for conv, bn in zip(self.stem_convs[:2], self.stem_bns[:2]):
            y = torch.relu(bn(conv(y)))
        stem = self.stem_convs[2](y)
        out = self.down(torch.relu(self.stem_bns[2](stem)))
        ups = []
        for i, layers in enumerate(self.blocks):
            for layer in layers:
                out = layer(out)
            ups.append(self.ups[i](out))
            if i < len(self.transitions):
                bn1, conv1, bn2, conv2 = self.transitions[i]
                out = conv2(torch.relu(bn2(conv1(torch.relu(bn1(out))))))
        cat = torch.cat([*ups, stem], dim=-1)
        return self.head(torch.relu(self.head_bn(cat))).float()
