"""``config.network`` -> model. Only ``unet`` is ported so far."""

from __future__ import annotations

from torch import nn

from .three_d.unet3d import UNet3D


def build_model(config) -> nn.Module:
    if config.network == "unet":
        return UNet3D.from_config(config)
    raise NotImplementedError(
        f"network '{config.network}' is not ported to PyTorch yet; only 'unet' is. "
        "ROADMAP.md lists the order in which the rest of the zoo is ported."
    )
