"""FusionNet: a U-Net and a V-Net side by side with a small CNN fusing
their logits, channels-last, as the JAX package's
``models/three_d/fusionnet.py``: UNet3D (init_features 64) and VNet on the
same input, their logits concatenated (2 + 2 = 4 channels by default) and
run through ConvBlock -> max-pool -> ConvBlock -> k2 s2 up-conv -> 1x1
head. UNet3D's 18 ConvBlocks and the fusion's 2 run the hand-written
kernels (the fusion stem's Cin of 4 their ragged variants); V-Net's convs
are ``F.conv3d``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import ConvBlock, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io, max_pool
from ...nn.blocks import remat_policy as block_remat
from .unet3d import UNet3D
from .vnet3d import VNet


class FusionNet(nn.Module):
    def __init__(
        self, in_channels: int = 1, out_channels: int = 2, unet_init_features: int = 64,
        cnn_init_features: int = 64, elu: bool = True, dtype: torch.dtype = torch.float32,
        init_type: str = "none", seed: int = 0, remat: bool = False, remat_policy: str = "",
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        policy = block_remat(remat_policy) if remat else None
        f = cnn_init_features
        self.unet = UNet3D(in_channels, out_channels, unet_init_features, dtype, init_type, seed + 1, remat,
                           remat_policy)
        self.unet.scope = "UNet3D_0"
        self.vnet = VNet(elu, in_channels, out_channels, dtype, init_type, seed + 2)
        self.vnet.scope = "VNet_0"
        blocks = ScopeNames()
        self.blocks = nn.ModuleList(
            blocks(ConvBlock(ci, co, dtype, init_type, gen, remat=policy))
            for ci, co in ((2 * out_channels, f), (f, 2 * f))
        )
        self.up = TorchConvTranspose(2 * f, f, dtype, init_type, gen)
        self.up.scope = "TorchConvTranspose_0"
        self.head = TorchConv(f, out_channels, dtype, init_type, gen, kernel_size=1)
        self.head.scope = "TorchConv_0"

    @classmethod
    def from_config(cls, config) -> "FusionNet":
        """``FusionNet(in_classes, out_classes)`` with the dataclass defaults,
        the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **model_kwargs(config, remat=True))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "FusionNet":
        """A model of the widths of the JAX FusionNet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin, f = flax_conv_io(params, "UNet3D_0", "ConvBlock_0", "TorchConv_0")
        fusion = flax_conv_io(params, "ConvBlock_0", "TorchConv_0")[1]
        return cls(cin, flax_conv_io(params, "TorchConv_0")[1], f, fusion, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.unet(x).to(x.dtype), self.vnet(x).to(x.dtype)], dim=-1)
        y = self.blocks[1](max_pool(self.blocks[0](y)))
        return self.head(self.up(y)).float()
