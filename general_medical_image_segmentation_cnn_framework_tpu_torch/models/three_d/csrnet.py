"""CSR-Net: a U-Net with cross-scale residual paths, channels-last, as the
JAX package's ``models/three_d/csrnet.py``: the 4-level BN-ReLU U-Net
(UNet3D's 18 ConvBlocks, the same widths) plus stride-4 conv skip
encoders (k3 s4 p0 conv -> BN -> ReLU, added into deeper encoder outputs)
and stride-4 transposed-conv decoder shortcuts (k4 s4 -> BN -> ReLU, added
into shallower decoder inputs). The 18 ConvBlocks run the hand-written
kernels; the k3 s4 convs are ``F.conv3d``, the transposed convs matmuls.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import ConvBlock, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io, max_pool
from ...nn.blocks import remat_policy as block_remat
from ...nn.norm import BatchNorm


class CSRNet(nn.Module):
    def __init__(
        self, in_channels: int = 1, out_channels: int = 2, init_features: int = 64,
        dtype: torch.dtype = torch.float32, init_type: str = "none", seed: int = 0,
        remat: bool = False, remat_policy: str = "",
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        f = init_features
        policy = block_remat(remat_policy) if remat else None
        blocks, convs, bns, ups = (ScopeNames() for _ in range(4))
        widths = [
            (in_channels, f), (f, f), (f, 2 * f), (2 * f, 2 * f), (2 * f, 4 * f), (4 * f, 4 * f),
            (4 * f, 8 * f), (8 * f, 8 * f), (8 * f, 16 * f), (16 * f, 16 * f),
            (16 * f, 8 * f), (8 * f, 8 * f), (8 * f, 4 * f), (4 * f, 4 * f),
            (4 * f, 2 * f), (2 * f, 2 * f), (2 * f, f), (f, f),
        ]
        self.blocks = nn.ModuleList(
            blocks(ConvBlock(ci, co, dtype, init_type, gen, remat=policy)) for ci, co in widths
        )
        # block_r: enc1 -> enc3, enc2 -> enc4, enc3 -> bottleneck
        self.skip_convs = nn.ModuleList(
            convs(TorchConv(ci, co, dtype, init_type, gen, kernel_size=3, stride=4, padding=0))
            for ci, co in ((f, 4 * f), (2 * f, 8 * f), (4 * f, 16 * f))
        )
        self.skip_bns = nn.ModuleList(bns(BatchNorm(c)) for c in (4 * f, 8 * f, 16 * f))
        # in the JAX call order: up(8f); then per decoder level its up and its k4 s4 shortcut
        self.up4 = ups(TorchConvTranspose(16 * f, 8 * f, dtype, init_type, gen))
        self.ups = nn.ModuleList()
        self.shortcuts = nn.ModuleList()
        for up_in, up_out, sc_in in ((8 * f, 4 * f, 16 * f), (4 * f, 2 * f, 8 * f), (2 * f, f, 4 * f)):
            self.ups.append(ups(TorchConvTranspose(up_in, up_out, dtype, init_type, gen)))
            self.shortcuts.append(ups(TorchConvTranspose(sc_in, up_out, dtype, init_type, gen, kernel_size=4)))
        self.shortcut_bns = nn.ModuleList(bns(BatchNorm(c)) for c in (4 * f, 2 * f, f))
        self.head = convs(TorchConv(f, out_channels, dtype, init_type, gen, kernel_size=1))

    @classmethod
    def from_config(cls, config) -> "CSRNet":
        """``CSRNet(in_classes, out_classes, init_features=32)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, 32, **model_kwargs(config, remat=True))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "CSRNet":
        """A model of the widths of the JAX CSRNet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin, f = flax_conv_io(params, "ConvBlock_0", "TorchConv_0")
        return cls(cin, flax_conv_io(params, "TorchConv_3")[1], f, **kwargs)

    def _bn_relu(self, bn, x):
        return torch.relu(bn(x).to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.blocks

        def block(z, i):
            return b[2 * i + 1](b[2 * i](z))

        enc1 = block(x, 0)
        enc2 = block(max_pool(enc1), 1)
        enc3 = block(max_pool(enc2), 2) + self._bn_relu(self.skip_bns[0], self.skip_convs[0](enc1))
        enc4 = block(max_pool(enc3), 3) + self._bn_relu(self.skip_bns[1], self.skip_convs[1](enc2))
        bottleneck = block(max_pool(enc4), 4) + self._bn_relu(self.skip_bns[2], self.skip_convs[2](enc3))
        dec4 = block(torch.cat([self.up4(bottleneck), enc4], dim=-1), 5)
        decs, skips = [bottleneck, dec4], (enc3, enc2, enc1)
        for i in range(3):
            shortcut = self._bn_relu(self.shortcut_bns[i], self.shortcuts[i](decs[-2]))
            up = self.ups[i](decs[-1]) + shortcut
            decs.append(block(torch.cat([up, skips[i]], dim=-1), 6 + i))
        return self.head(decs[-1]).float()
