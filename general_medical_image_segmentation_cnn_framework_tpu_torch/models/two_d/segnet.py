"""SegNet (Badrinarayanan et al. 2017) on NHWC slices, as the JAX
package's ``models/two_d/segnet.py``: a VGG16 encoder of conv -> BatchNorm
-> ReLU blocks (2, 2, 3, 3, 3 at 64, 128, 256, 512, 512), each stage
ending in a 2x2 max pool that records its window's argmax as a one-hot
mask (``nn.blocks.max_pool_with_mask``), a mirrored decoder that unpools
through those masks, and a k3 head. The 25 ConvBlocks and the head (k3 s1
p1) run the KD = 1 instances of the hand-written kernels, 26 calls a
forward. The input's H and W must divide by 32."""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import ConvBlock, ScopeNames, TorchConv, flax_conv_io, max_pool_with_mask, max_unpool_with_mask

ENCODER = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
DECODER = ((512, 512, 512), (512, 512, 256), (256, 256, 128), (128, 64), (64,))


class SegNet(nn.Module):
    def __init__(
        self, input_nbr: int = 1, label_nbr: int = 2, dtype: torch.dtype = torch.float32, init_type: str = "none",
        seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        names = ScopeNames()
        widths, c = [], input_nbr
        for feats, n in ENCODER:
            for _ in range(n):
                widths.append((c, feats))
                c = feats
        for feats_list in DECODER:
            for feats in feats_list:
                widths.append((c, feats))
                c = feats
        self.blocks = nn.ModuleList(names(ConvBlock(ci, co, dtype, init_type, gen, ndim=2)) for ci, co in widths)
        self.head = names(TorchConv(c, label_nbr, dtype, init_type, gen, ndim=2, kernel_size=3, padding=1))

    @classmethod
    def from_config(cls, config) -> "SegNet":
        """``SegNet(in_classes, out_classes)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "SegNet":
        """A model of the channels of the JAX SegNet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        return cls(flax_conv_io(params, "ConvBlock_0", "TorchConv_0")[0], flax_conv_io(params, "TorchConv_0")[1],
                   **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks, masks = iter(self.blocks), []
        y = x
        for _, n in ENCODER:
            for _ in range(n):
                y = next(blocks)(y)
            y, mask = max_pool_with_mask(y)
            masks.append(mask)
        for feats_list in DECODER:
            y = max_unpool_with_mask(y, masks.pop())
            for _ in feats_list:
                y = next(blocks)(y)
        return self.head(y).float()
