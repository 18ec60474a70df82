"""Double U-Net: a coarse-to-fine cascade with squeeze-excite gated fine
skips, channels-last, as the JAX package's
``models/three_d/double_unet.py``: a 3-level coarse U-Net at half width
whose logits are concatenated with the input (1 + 2 = 3 channels by
default) and fed to a 3-level fine U-Net whose skips pass through
``SEResidual``; returns the fine logits. The up-convs keep their channel
count, so the decoders concatenate 3x widths. Its 28 ConvBlocks run the
hand-written kernels; the fine stem's Cin of 3 takes their ragged
variants.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import ConvBlock, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io, max_pool
from ...nn.blocks import remat_policy as block_remat
from ...nn.residual import SEResidual


class _UNet3Level(nn.Module):
    def __init__(self, cin, f, out_channels, use_se_skips, dtype, init_type, gen, remat):
        super().__init__()
        blocks, ups, ses = ScopeNames(), ScopeNames(), ScopeNames()
        widths = [(cin, f), (f, f), (f, 2 * f), (2 * f, 2 * f), (2 * f, 4 * f), (4 * f, 4 * f),
                  (4 * f, 8 * f), (8 * f, 8 * f), (12 * f, 4 * f), (4 * f, 4 * f), (6 * f, 2 * f), (2 * f, 2 * f),
                  (3 * f, f), (f, f)]
        self.blocks = nn.ModuleList(blocks(ConvBlock(ci, co, dtype, init_type, gen, remat=remat)) for ci, co in widths)
        self.ups = nn.ModuleList(ups(TorchConvTranspose(c, c, dtype, init_type, gen)) for c in (8 * f, 4 * f, 2 * f))
        self.ses = (nn.ModuleList(ses(SEResidual(c, dtype=dtype, generator=gen)) for c in (4 * f, 2 * f, f))
                    if use_se_skips else None)
        self.head = TorchConv(f, out_channels, dtype, init_type, gen, kernel_size=1)
        self.head.scope = "TorchConv_0"

    def forward(self, x):
        b = self.blocks
        skips = []
        for i in range(4):
            x = b[2 * i + 1](b[2 * i](max_pool(x) if i else x))
            skips.append(x)
        y = skips.pop()
        for i in range(3):
            skip = skips.pop()
            if self.ses is not None:
                skip = self.ses[i](skip)
            y = torch.cat([self.ups[i](y), skip], dim=-1)
            y = b[9 + 2 * i](b[8 + 2 * i](y))
        return self.head(y)


class DoubleUNet(nn.Module):
    def __init__(
        self, in_channels: int = 1, out_channels: int = 2, unet_init_features: int = 64,
        dtype: torch.dtype = torch.float32, init_type: str = "none", seed: int = 0,
        remat: bool = False, remat_policy: str = "",
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        policy = block_remat(remat_policy) if remat else None
        names = ScopeNames()
        f = unet_init_features
        self.coarse = names(_UNet3Level(in_channels, f // 2, out_channels, False, dtype, init_type, gen, policy))
        self.fine = names(_UNet3Level(in_channels + out_channels, f, out_channels, True, dtype, init_type, gen,
                                      policy))

    @classmethod
    def from_config(cls, config) -> "DoubleUNet":
        """``DoubleUNet(in_classes, out_classes)`` with the dataclass
        defaults (unet_init_features=64), the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **model_kwargs(config, remat=True))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "DoubleUNet":
        """A model of the widths of the JAX DoubleUNet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin = flax_conv_io(params, "_UNet3Level_0", "ConvBlock_0", "TorchConv_0")[0]
        return cls(cin, flax_conv_io(params, "_UNet3Level_1", "TorchConv_0")[1],
                   flax_conv_io(params, "_UNet3Level_1", "ConvBlock_0", "TorchConv_0")[1], **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        coarse = self.coarse(x)
        return self.fine(torch.cat([x, coarse.to(x.dtype)], dim=-1)).float()
