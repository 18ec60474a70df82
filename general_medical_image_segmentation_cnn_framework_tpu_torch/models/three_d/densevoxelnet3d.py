"""DenseVoxelNet (Yu et al. 2017), channels-last, as the JAX package's
``models/three_d/densevoxelnet3d.py``: a k1 s2 stem to 16 channels, two
dense blocks of 12 layers (BatchNorm -> ReLU -> k3 conv to 12 channels ->
Dropout(0.2), concatenated to the layer's input) around a transition
(BatchNorm -> ReLU -> 1x1 conv, whose output ``t`` is kept, then a 2x max
pool), then BatchNorm -> ReLU -> 1x1 conv and two k2 s2 up-convs to the
main logits ``y1``; the auxiliary ``t`` -> k2 s2 up-conv -> the same 1x1
``conv_final`` (one module, one set of weights, called twice) gives ``y2``.

As in the JAX model, ``forward`` returns the auxiliary ``y2`` (``(y2,
y1)`` with ``return_both``): the loss reads the stem, the first dense
block, the transition conv, the auxiliary up-conv and ``conv_final`` only.
In train mode the whole network runs (the second block's BatchNorm
statistics move); in eval mode, without ``return_both``, only what ``y2``
needs runs, which is all of the graph that the JAX predict keeps of its
jitted forward (XLA drops the rest, whose output nothing reads).

The 24 dense-layer convs (k3 s1 p1, Cout 12) run the hand-written
kernels: 24 calls a train-mode forward, 12 in eval.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import Dropout, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io, max_pool
from ...nn.norm import BatchNorm

GROWTH = 12
LAYERS = 12


class _DenseLayer(nn.Module):
    """BatchNorm -> ReLU -> k3 conv (no bias) -> Dropout, concatenated to x."""

    def __init__(self, cin, growth, dtype, init_type, gen, drop_rate=0.2):
        super().__init__()
        self.bn = BatchNorm(cin)
        self.bn.scope = "BatchNorm_0"
        self.conv = TorchConv(cin, growth, dtype, init_type, gen, kernel_size=3, padding=1, use_bias=False)
        self.conv.scope = "TorchConv_0"
        self.dropout = Dropout(drop_rate, generator=gen)

    def forward(self, x):
        return torch.cat([x, self.dropout(self.conv(torch.relu(self.bn(x))))], dim=-1)


class DenseVoxelNet(nn.Module):
    def __init__(
        self, in_channels: int = 1, classes: int = 2, dtype: torch.dtype = torch.float32, init_type: str = "none",
        seed: int = 0, return_both: bool = False,
    ):
        super().__init__()
        self.dtype, self.return_both = dtype, return_both
        gen = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, init_type=init_type, generator=gen)
        names = ScopeNames()
        self.stem = names(TorchConv(in_channels, 16, kernel_size=1, stride=2, padding=0, use_bias=False, **kw))
        c = 16
        self.block1 = nn.ModuleList()
        for _ in range(LAYERS):
            self.block1.append(names(_DenseLayer(c, GROWTH, dtype, init_type, gen)))
            c += GROWTH
        self.trans_conv = names(TorchConv(c, 160, kernel_size=1, padding=0, **kw))
        self.trans_bn = names(BatchNorm(c))
        c = 160
        self.block2 = nn.ModuleList()
        for _ in range(LAYERS):
            self.block2.append(names(_DenseLayer(c, GROWTH, dtype, init_type, gen)))
            c += GROWTH
        self.up_conv = names(TorchConv(c, 304, kernel_size=1, padding=0, use_bias=False, **kw))
        self.up_bn = names(BatchNorm(c))
        self.up1 = names(TorchConvTranspose(304, 128, **kw))
        self.up2 = names(TorchConvTranspose(128, 64, **kw))
        self.conv_final = names(TorchConv(64, classes, kernel_size=1, padding=0, use_bias=False, **kw))
        self.aux_up = names(TorchConvTranspose(160, 64, **kw))

    @classmethod
    def from_config(cls, config) -> "DenseVoxelNet":
        """``DenseVoxelNet(in_classes, out_classes)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "DenseVoxelNet":
        """A model of the channels of the JAX DenseVoxelNet's params tree;
        ``kwargs`` (``dtype``, ...) go to the constructor."""
        return cls(flax_conv_io(params, "TorchConv_0")[0], flax_conv_io(params, "TorchConv_3")[1], **kwargs)

    def forward(self, x: torch.Tensor):
        """``y2``, or ``(y2, y1)`` with ``return_both``."""
        y = self.stem(x)
        for layer in self.block1:
            y = layer(y)
        t = self.trans_conv(torch.relu(self.trans_bn(y)))
        y2 = self.conv_final(self.aux_up(t)).float()
        if not (self.training or self.return_both):
            return y2
        y = max_pool(t, 2)
        for layer in self.block2:
            y = layer(y)
        y = self.up2(self.up1(self.up_conv(torch.relu(self.up_bn(y)))))
        y1 = self.conv_final(y).float()
        return (y2, y1) if self.return_both else y2
