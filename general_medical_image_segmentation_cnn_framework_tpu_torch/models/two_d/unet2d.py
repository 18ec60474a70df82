"""2-D U-Net (milesial-style) on channels-last NHWC slices.

Same topology as the JAX package's ``models/two_d/unet2d.py``: double
ConvBlocks (conv-BN-ReLU x2) at 64/128/256/512/512 with 2x max-pool downs,
bilinear x2 ups (align_corners=True) padded to the skip's size, skip
concatenation ``[skip, up]``, and a 1x1 head. The 18 ConvBlocks are
``blocks[0..17]`` in call order (the JAX ``ConvBlock_i``); every one is a
k3 s1 SAME 2-D conv, so on a card every conv of the network runs the
hand-written 2-D kernels (``ops.conv3d_bn_relu.conv2d_bn_relu`` in eval,
``conv2d_k3s1`` in train).

``dtype`` is the compute dtype: with bfloat16, activations and conv
weights are bfloat16 while parameters, BatchNorm folding and biases stay
float32, and the logits are cast to float32, as in the JAX model. Every
kernel, the head's included, is drawn from ``kernel_initializer(init_type)``
with a ``torch.Generator`` seeded with ``seed`` (the JAX head is a
``TorchConv``, not a plain Flax ``nn.Conv`` as in UNet3D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.blocks import ConvBlock, ScopeNames, TorchConv, flax_conv_io, max_pool, resize_linear_align_corners

WIDTHS = (64, 128, 256, 512, 512)


class UNet2D(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        classes: int = 2,
        init_type: str = "none",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        f1, f2, f3, f4, f5 = WIDTHS
        # (Cin, Cout) of ConvBlock_i: the encoder's double convs, then each up's
        # double conv on [skip, up] (the up keeps the channels it comes with)
        widths = [
            (in_channels, f1), (f1, f1), (f1, f2), (f2, f2), (f2, f3), (f3, f3),
            (f3, f4), (f4, f4), (f4, f5), (f5, f5),
            (f4 + f5, 256), (256, 256), (f3 + 256, 128), (128, 128),
            (f2 + 128, 64), (64, 64), (f1 + 64, 64), (64, 64),
        ]
        names = ScopeNames()
        self.blocks = nn.ModuleList(names(ConvBlock(ci, co, dtype, init_type, gen, ndim=2)) for ci, co in widths)
        self.head = names(TorchConv(64, classes, dtype, init_type, gen, ndim=2, kernel_size=1))

    @classmethod
    def from_config(cls, config) -> "UNet2D":
        """The model the CLIs build: ``UNet2D(in_classes, out_classes)`` with
        ``config.init_type`` drawn from ``config.seed``."""
        return cls(
            in_channels=config.in_classes,
            classes=config.out_classes,
            init_type=getattr(config, "init_type", "none") or "none",
            dtype=torch.bfloat16 if getattr(config, "precision", "") == "bfloat16" else torch.float32,
            seed=int(getattr(config, "seed", 0) or 0),
        )

    @classmethod
    def from_flax(cls, params, **kwargs) -> "UNet2D":
        """A model of the channels of the JAX UNet2D's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin = flax_conv_io(params, "ConvBlock_0", "TorchConv_0")[0]
        return cls(cin, flax_conv_io(params, "TorchConv_0")[1], **kwargs)

    def _up(self, x1: torch.Tensor, x2: torch.Tensor, i: int) -> torch.Tensor:
        """Upsample x1 x2, zero-pad it to x2's size (odd sizes), concat
        ``[x2, x1]`` and run ConvBlocks i, i + 1."""
        x1 = resize_linear_align_corners(x1, (2 * x1.shape[1], 2 * x1.shape[2]))
        dh, dw = x2.shape[1] - x1.shape[1], x2.shape[2] - x1.shape[2]
        x1 = F.pad(x1, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        y = torch.cat([x2, x1], dim=-1)
        return self.blocks[i + 1](self.blocks[i](y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, in_channels] -> float32 logits [N, H, W, classes]."""
        b = self.blocks
        x1 = b[1](b[0](x))
        x2 = b[3](b[2](max_pool(x1)))
        x3 = b[5](b[4](max_pool(x2)))
        x4 = b[7](b[6](max_pool(x3)))
        y = b[9](b[8](max_pool(x4)))
        for i, skip in enumerate((x4, x3, x2, x1)):
            y = self._up(y, skip, 10 + 2 * i)
        return self.head(y).float()
