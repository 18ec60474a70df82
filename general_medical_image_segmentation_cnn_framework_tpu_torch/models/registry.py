"""``config.network`` -> model. Ported so far: ``unet`` (UNet3D) and
``unet2d`` (UNet2D)."""

from __future__ import annotations

from typing import Callable

from torch import nn

from .three_d.unet3d import UNet3D
from .two_d.unet2d import UNet2D

# 2-D networks operate on [B, H, W, C] slices; the train and predict entry
# points adapt [B, 1, H, W, C] patches by dropping and restoring the depth
# axis (the JAX package's list, models/registry.py there)
TWO_D_NETWORKS = {
    "unet2d", "unetpp", "segnet", "fcn2d", "deeplab", "pspnet",
    "miniseg", "highres2dnet",
}
_FACTORIES = {"unet": UNet3D.from_config, "unet2d": UNet2D.from_config}


def is_2d(network: str) -> bool:
    return network in TWO_D_NETWORKS


# Total spatial downsampling factor per 3-D network: whole-volume
# inference pads each spatial dim to this multiple so every pool/merge
# divides cleanly (and the decoder's upsamples line back up with skips).
# The JAX package's table, models/registry.py there.
_PAD_MULTIPLE = {
    "vtnet": 32,  # k4s4 embed x 3 PatchMergings (H/W); windows self-pad
    "unetr": 16,  # k16s16 patch embed
    "highresnet": 1,  # fully dilated, no downsampling
}


def pad_multiple(network: str) -> int:
    """Spatial-dim multiple required for a clean whole-volume forward
    (default 16 = four stride-2 stages, the U-Net family)."""
    return _PAD_MULTIPLE.get(network, 16)


def make_forward(config, model: nn.Module) -> Callable:
    """``x [B, D, H, W, C] -> logits [B, D, H, W, classes]``: the model
    itself, or for a 2-D network the slice adapter, which runs it on
    ``x[:, 0]`` (D must be 1) and returns its logits with the depth axis
    restored."""
    if not is_2d(config.network):
        return model

    def forward(x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != 1:
            raise ValueError(
                f"2-D network '{config.network}' needs patch_size '1, H, W', got depth {x.shape[1]}"
            )
        return model(x[:, 0])[:, None]

    return forward


def build_model(config) -> nn.Module:
    if config.network in _FACTORIES:
        return _FACTORIES[config.network](config)
    raise NotImplementedError(
        f"network '{config.network}' is not ported to PyTorch yet; only "
        f"{', '.join(repr(n) for n in _FACTORIES)} are. "
        "ROADMAP.md lists the order in which the rest of the zoo is ported."
    )
