"""``config.network`` -> model: every network of the JAX package's zoo,
``unet`` (UNet3D), ``unet2d`` (UNet2D), fourteen more 3-D ones
(``res_unet``, ``vnet``, ``highresnet``, ``csrnet``, ``er_net``,
``re_net``, ``IS``, ``dunet``, ``fusionnet``, ``densevoxelnet``,
``densenet``, ``fcn3d`` and the transformers ``unetr`` and ``vtnet``) and
seven 2-D nets (``highres2dnet``, ``segnet``, ``unetpp``, ``fcn2d``,
``deeplab``, ``pspnet``, ``miniseg``), each at its JAX ``from_config``
width."""

from __future__ import annotations

import importlib
from typing import Callable

import torch
from torch import nn

# 2-D networks operate on [B, H, W, C] slices; the train and predict entry
# points adapt [B, 1, H, W, C] patches by dropping and restoring the depth
# axis (the JAX package's list, models/registry.py there)
TWO_D_NETWORKS = {
    "unet2d", "unetpp", "segnet", "fcn2d", "deeplab", "pspnet",
    "miniseg", "highres2dnet",
}
# network -> (module under models/, class): each class has ``from_config``
_MODELS = {
    "unet": ("three_d.unet3d", "UNet3D"),
    "unet2d": ("two_d.unet2d", "UNet2D"),
    "res_unet": ("three_d.residual_unet3d", "ResidualUNet3D"),
    "vnet": ("three_d.vnet3d", "VNet"),
    "highresnet": ("three_d.highresnet", "HighResNet"),
    "csrnet": ("three_d.csrnet", "CSRNet"),
    "er_net": ("three_d.er_net", "ERNet"),
    "re_net": ("three_d.re_net", "RENet"),
    "IS": ("three_d.is_net", "ISNet"),
    "dunet": ("three_d.double_unet", "DoubleUNet"),
    "fusionnet": ("three_d.fusionnet", "FusionNet"),
    "densevoxelnet": ("three_d.densevoxelnet3d", "DenseVoxelNet"),
    "densenet": ("three_d.densenet3d", "SkipDenseNet3D"),
    "fcn3d": ("three_d.fcn3d", "FCN3D"),
    "unetr": ("three_d.unetr", "UNETR"),
    "vtnet": ("three_d.vtnet", "VTUNet"),
    "highres2dnet": ("two_d.highresnet2d", "HighRes2DNet"),
    "segnet": ("two_d.segnet", "SegNet"),
    "unetpp": ("two_d.unetpp", "UNetPlusPlus"),
    "fcn2d": ("two_d.fcn2d", "FCN32s"),
    "deeplab": ("two_d.deeplab", "DeepLabV3"),
    "pspnet": ("two_d.pspnet", "PSPNet"),
    "miniseg": ("two_d.miniseg", "MiniSeg"),
}


def is_2d(network: str) -> bool:
    return network in TWO_D_NETWORKS


# Total spatial downsampling factor per 3-D network: whole-volume
# inference pads each spatial dim to this multiple so every pool/merge
# divides cleanly (and the decoder's upsamples line back up with skips).
# The JAX package's table, models/registry.py there. The default 16 also
# serves densevoxelnet (its stem and pool halve twice), densenet (its down
# conv and three transitions, four halvings) and fcn3d (its pools and crops
# fit every multiple of 16 from 32 on).
_PAD_MULTIPLE = {
    "vtnet": 32,  # k4s4 embed x 3 PatchMergings (H/W); windows self-pad
    "unetr": 16,  # k16s16 patch embed
    "highresnet": 1,  # fully dilated, no downsampling
}


def pad_multiple(network: str) -> int:
    """Spatial-dim multiple required for a clean whole-volume forward
    (default 16 = four stride-2 stages, the U-Net family)."""
    return _PAD_MULTIPLE.get(network, 16)


def model_kwargs(config, remat: bool = False) -> dict:
    """The keyword arguments every ``from_config`` takes from the config:
    the compute ``dtype`` (``precision``), ``init_type`` and the ``seed``
    of the weights' generator; with ``remat``, ``remat`` and
    ``remat_policy`` for the network's ConvBlocks."""
    kw = dict(
        dtype=torch.bfloat16 if getattr(config, "precision", "") == "bfloat16" else torch.float32,
        init_type=getattr(config, "init_type", "none") or "none",
        seed=int(getattr(config, "seed", 0) or 0),
    )
    if remat:
        kw.update(remat=bool(getattr(config, "remat", False)),
                  remat_policy=str(getattr(config, "remat_policy", "") or ""))
    return kw


def model_class(network: str) -> type:
    """The port's class of ``network``; ``KeyError`` for an unknown name."""
    if network not in _MODELS:
        raise KeyError(f"unknown network '{network}'; available: {sorted(_MODELS)}")
    module, cls = _MODELS[network]
    return getattr(importlib.import_module(f".{module}", __package__), cls)


def make_forward(config, model: nn.Module) -> Callable:
    """``x [B, D, H, W, C] -> logits [B, D, H, W, classes]``, as the JAX
    drivers call each network: IS gives the first of its two outputs, in
    train mode from x and its FFT bands (``ops.fft.band_split(x, 0.04)``:
    every decoder runs, as their BatchNorm statistics move), otherwise from
    x alone (what the JAX predict's jitted forward keeps: the bands, the
    other two decoders and the second head feed nothing it returns); a
    2-D network runs on ``x[:, 0]`` (D must be 1), its logits
    (the first element of a tuple) get the depth axis back; any other 3-D
    network is the model itself (DenseVoxelNet returns its auxiliary
    ``y2``, and in eval runs only what ``y2`` needs)."""
    if config.network == "IS":
        from ..ops.fft import band_split

        def forward_is(x: torch.Tensor) -> torch.Tensor:
            # serving's export passes a function of the weights, which is never in train mode
            if getattr(model, "training", False):
                return model(x, *band_split(x, limit=0.04))[0]
            return model(x)[0]

        return forward_is
    if not is_2d(config.network):
        return model

    def forward(x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != 1:
            raise ValueError(
                f"2-D network '{config.network}' needs patch_size '1, H, W', got depth {x.shape[1]}"
            )
        out = model(x[:, 0])
        return (out[0] if isinstance(out, tuple) else out)[:, None]

    return forward


def build_model(config) -> nn.Module:
    """The network ``config.network`` names, built by its ``from_config``."""
    return model_class(config.network).from_config(config)
