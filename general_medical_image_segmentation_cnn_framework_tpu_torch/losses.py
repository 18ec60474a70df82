"""Losses of the binary train step, on channels-last tensors.

The counterparts of the JAX package's ``losses.one_hot_background`` and
``losses.bce_with_logits`` (the reference's BCEWithLogitsLoss on the
constructed (background, foreground) target). The train step itself runs
the fused one-pass version, ``ops.fused_bce_dice``; these are its
definition and the tests' oracle.
"""

from __future__ import annotations

import torch


def one_hot_background(gt: torch.Tensor) -> torch.Tensor:
    """gt [B, ..., 1] binary -> [B, ..., 2]: channel 0 = (gt == 0), channel 1 = gt."""
    return torch.cat([(gt == 0).to(gt.dtype), gt], dim=-1)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCEWithLogitsLoss, mean reduction, in f32:
    mean(max(x, 0) - x*t + log1p(exp(-|x|)))."""
    x, t = logits.float(), targets.float()
    return (torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()
