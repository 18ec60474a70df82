"""Config composition: the JAX package's YAML/override module, reused.

The port reads the same ``configs/`` tree and takes the same
``config=<group> config.KEY=VALUE`` overrides. Keys that only steer the JAX
runtime on a TPU are accepted and ignored (``log_ignored_keys``); on CUDA
the eval ConvBlock always runs the hand-written kernel, so the conv-route
switches among them select nothing here.
"""

from __future__ import annotations

import logging

from general_medical_image_segmentation_cnn_framework_tpu.config import ConfigDict, compose  # noqa: F401

TPU_ONLY_KEYS = (
    "platform",
    "mesh_shape",
    "compilation_cache_dir",
    "jax_debug_nans",
    "dp_backend",
    "pallas_conv",
    "tlayout_conv",
    "tlayout_v2",
    "s2d_conv",
)


def log_ignored_keys(config, logger: logging.Logger) -> None:
    """One log line naming the TPU-only keys present in ``config``."""
    present = [k for k in TPU_ONLY_KEYS if k in config]
    if present:
        logger.info(f"ignored on this backend (TPU-only config keys): {', '.join(present)}")
