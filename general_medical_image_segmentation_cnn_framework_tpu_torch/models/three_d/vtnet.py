"""VT-UNet, as the JAX package's ``models/three_d/vtnet.py``: a
``SwinTransformerSys3D`` (its one child scope) with embed 96, depths
2, 2, 2, 1, heads 3, 6, 12, 24, window 7^3, patch 4^3 and drop path up to
0.1. The JAX ``img_size`` (``config.patch_size``) feeds nothing the
network computes, so the port takes no such argument: any input whose H and
W, after the patch embed's padding to a multiple of 4, halve evenly through
the three merges runs (the whole volume pads to a multiple of 32).
"""

from __future__ import annotations

import torch
from torch import nn

from .vt_unet import SwinTransformerSys3D


class VTUNet(nn.Module):
    def __init__(self, num_classes: int = 2, input_dim: int = 1, embed_dim: int = 96, win_size: int = 7,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.swin = SwinTransformerSys3D(
            patch_size=(4, 4, 4), in_chans=input_dim, num_classes=num_classes, embed_dim=embed_dim,
            depths=(2, 2, 2, 1), num_heads=(3, 6, 12, 24), window_size=(win_size,) * 3, mlp_ratio=4.0,
            qkv_bias=True, drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.1, dtype=dtype,
            generator=torch.Generator().manual_seed(seed))
        self.swin.scope = "SwinTransformerSys3D_0"

    @classmethod
    def from_config(cls, config) -> "VTUNet":
        """``VTUNet(out_classes, in_classes)`` at the JAX ``from_config``
        width; ``init_type`` does not apply (the JAX VT-UNet's kernels are
        Flax's LeCun-normal)."""
        from ..registry import model_kwargs

        kw = model_kwargs(config)
        return cls(config.out_classes, config.in_classes, dtype=kw["dtype"], seed=kw["seed"])

    @classmethod
    def from_flax(cls, params, **kwargs) -> "VTUNet":
        """A model of the widths of the JAX VT-UNet's params tree (embed and
        channels from the two convs' kernels, the window from the first bias
        table's (2w - 1)^3 rows); ``kwargs`` (``dtype``, ...) go to the
        constructor."""
        tree = params["SwinTransformerSys3D_0"]
        cin, embed = tree["Conv_0"]["kernel"].shape[-2:]
        attn = tree["BasicLayer_0"]["SwinTransformerBlock3D_0"]["WindowAttention3D_0"]
        rows = attn["relative_position_bias_table"].shape[0]
        win = (round(rows ** (1 / 3)) + 1) // 2
        return cls(int(tree["Conv_1"]["kernel"].shape[-1]), int(cin), int(embed), win, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.swin(x)
