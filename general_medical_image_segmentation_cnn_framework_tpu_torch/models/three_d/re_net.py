"""RE-Net: ER-Net's reverse-attention encoder with a plain two-conv decoder
over concatenated features, channels-last, as the JAX package's
``models/three_d/re_net.py``: 2 output channels and a final sigmoid, as
there (the reference hard-codes both). Its 14 k3 s1 p1 convs are bare
``TorchConv``s: the hand-written kernels in train mode, the eval conv in
eval.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io
from ...nn.norm import BatchNorm
from .er_net import ReverseAttentionEncoder


class RENet(nn.Module):
    def __init__(self, in_channels: int = 1, dtype: torch.dtype = torch.float32, init_type: str = "none",
                 seed: int = 0):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        convs, ups, bns = ScopeNames(), ScopeNames(), ScopeNames()
        self.encoder = ReverseAttentionEncoder(in_channels, dtype, init_type, gen, ScopeNames(), convs, ups)
        self.deconvs = nn.ModuleList(
            ups(TorchConvTranspose(ci, co, dtype, init_type, gen)) for ci, co in ((256, 128), (128, 64), (64, 32))
        )
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        for c in (128, 64, 32):
            for ci in (2 * c, c):
                self.convs.append(convs(TorchConv(ci, c, dtype, init_type, gen, kernel_size=3, padding=1)))
                self.bns.append(bns(BatchNorm(c)))
        self.head = convs(TorchConv(32, 2, dtype, init_type, gen, kernel_size=1))

    @classmethod
    def from_config(cls, config) -> "RENet":
        """The JAX ``from_config`` takes no channels (1 in, 2 out in the
        reference); the port builds its first convs for ``in_classes``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "RENet":
        """A model of the widths of the JAX RENet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        return cls(flax_conv_io(params, "ResEncoder_0", "TorchConv_1")[0], **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, *gated = self.encoder(x)
        for i, (deconv, skip) in enumerate(zip(self.deconvs, gated)):
            out = torch.cat([deconv(out), skip], dim=-1)
            for j in (2 * i, 2 * i + 1):
                out = torch.relu(self.bns[j](self.convs[j](out)).to(self.dtype))
        return torch.sigmoid(self.head(out)).float()
