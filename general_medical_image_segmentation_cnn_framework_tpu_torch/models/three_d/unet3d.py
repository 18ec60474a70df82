"""3-D U-Net, the framework's flagship model, on channels-last tensors.

Same topology as the JAX package's ``models/three_d/unet3d.py``: four
levels of (ConvBlock x2) with 2x max-pool down, a bottleneck, four k2 s2
transposed-conv ups with skip concatenation, and a 1x1x1 head. The 18
ConvBlocks are ``blocks[0..17]`` in call order (the JAX ``ConvBlock_i``).

``dtype`` is the compute dtype: with bfloat16, activations and folded conv
weights are bfloat16 while parameters, BatchNorm folding and biases stay
float32, and the head's logits are cast to float32, as in the JAX model.
One module tree serves train mode (the conv kernels with their gradients,
batch-statistics BatchNorm) and eval mode (BatchNorm folded into one
kernel per ConvBlock).

Kernels are initialised by ``init_type`` (``nn.init``) from a
``torch.Generator`` seeded with ``seed``; the head, a plain Flax
``nn.Conv`` in the JAX model, keeps Flax's default LeCun-normal init.

``remat=True`` recomputes each ConvBlock in the backward by
``remat_policy`` ('' / 'full', 'conv' or 'dots'; ``nn.blocks.ConvBlock``),
as the JAX model's ``nn.remat`` of its blocks. The module tree, and so the
checkpoint, does not depend on it.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import ConvBlock, ScopeNames, TorchConvTranspose, flax_conv_io, max_pool
from ...nn.blocks import remat_policy as block_remat
from ...nn.init import lecun_normal


class UNet3D(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 2,
        init_features: int = 32,
        dtype: torch.dtype = torch.float32,
        init_type: str = "none",
        seed: int = 0,
        remat: bool = False,
        remat_policy: str = "",
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        f = init_features
        widths = [
            (in_channels, f), (f, f), (f, 2 * f), (2 * f, 2 * f),
            (2 * f, 4 * f), (4 * f, 4 * f), (4 * f, 8 * f), (8 * f, 8 * f),
            (8 * f, 16 * f), (16 * f, 16 * f),
            (16 * f, 8 * f), (8 * f, 8 * f), (8 * f, 4 * f), (4 * f, 4 * f),
            (4 * f, 2 * f), (2 * f, 2 * f), (2 * f, f), (f, f),
        ]
        policy = block_remat(remat_policy) if remat else None
        blocks, ups = ScopeNames(), ScopeNames()
        self.blocks = nn.ModuleList(blocks(ConvBlock(ci, co, dtype, init_type, gen, remat=policy)) for ci, co in widths)
        self.ups = nn.ModuleList(
            ups(TorchConvTranspose(ci, co, dtype, init_type, gen))
            for ci, co in ((16 * f, 8 * f), (8 * f, 4 * f), (4 * f, 2 * f), (2 * f, f))
        )
        self.head = nn.Linear(f, out_channels)  # the 1x1x1 conv on channels-last
        self.head.scope = "Conv_0"
        with torch.no_grad():
            self.head.weight.copy_(lecun_normal((f, out_channels), gen).T)
            self.head.bias.zero_()

    @classmethod
    def from_config(cls, config) -> "UNet3D":
        """The model the CLIs build: ``UNet3D(in_classes, out_classes, 32)``
        with ``config.init_type`` drawn from ``config.seed``, and
        ``config.remat`` / ``config.remat_policy``."""
        return cls(
            in_channels=config.in_classes,
            out_channels=config.out_classes,
            init_features=32,
            dtype=torch.bfloat16 if getattr(config, "precision", "") == "bfloat16" else torch.float32,
            init_type=getattr(config, "init_type", "none") or "none",
            seed=int(getattr(config, "seed", 0) or 0),
            remat=bool(getattr(config, "remat", False)),
            remat_policy=str(getattr(config, "remat_policy", "") or ""),
        )

    @classmethod
    def from_flax(cls, params, **kwargs) -> "UNet3D":
        """A model of the widths of the JAX UNet3D's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin, f = flax_conv_io(params, "ConvBlock_0", "TorchConv_0")
        return cls(cin, flax_conv_io(params, "Conv_0")[1], f, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, D, H, W, in_channels] -> float32 logits [N, D, H, W, out_channels]."""
        b = self.blocks
        enc1 = b[1](b[0](x))
        enc2 = b[3](b[2](max_pool(enc1)))
        enc3 = b[5](b[4](max_pool(enc2)))
        enc4 = b[7](b[6](max_pool(enc3)))
        y = b[9](b[8](max_pool(enc4)))
        for i, skip in enumerate((enc4, enc3, enc2, enc1)):
            y = torch.cat([self.ups[i](y), skip], dim=-1)
            y = b[11 + 2 * i](b[10 + 2 * i](y))
        w, bias = self.head.weight.to(self.dtype), self.head.bias.to(self.dtype)
        return nn.functional.linear(y.to(self.dtype), w, bias).float()
