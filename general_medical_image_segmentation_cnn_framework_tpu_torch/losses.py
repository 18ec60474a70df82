"""Loss functions on channels-last tensors, computed in f32.

The counterparts of the JAX package's ``losses.py``:

* ``one_hot_background`` and ``bce_with_logits``: the reference's
  BCEWithLogitsLoss on the constructed (background, foreground) target. The
  binary train step runs the fused one-pass version, ``ops.fused_bce_dice``;
  these are its definition and the tests' oracle;
* ``cross_entropy``: log-softmax over the last axis + NLL over every voxel;
* ``binary_dice_loss``: per-sample soft dice on activated predictions
  (smooth 1, p 2);
* ``dice_loss``: sigmoid + global soft dice over the whole batch, eps 1e-5;
* ``multiclass_dice_loss``: per-class soft dice over a one-hot target,
  smooth 1e-5;
* ``focal_loss``: binary focal loss on logits, alpha 0.25, gamma 2.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def one_hot_background(gt: torch.Tensor) -> torch.Tensor:
    """gt [B, ..., 1] binary -> [B, ..., 2]: channel 0 = (gt == 0), channel 1 = gt."""
    return torch.cat([(gt == 0).to(gt.dtype), gt], dim=-1)


def _bce_terms(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """max(x, 0) - x*t + log1p(exp(-|x|)), elementwise."""
    return torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCEWithLogitsLoss, mean reduction, in f32."""
    return _bce_terms(logits.float(), targets.float()).mean()


def cross_entropy(
    logits: torch.Tensor,
    target_indices: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    size_average: bool = True,
) -> torch.Tensor:
    """log_softmax over the channels (last axis) + NLL summed over all voxels,
    divided by the voxel count when ``size_average``.

    logits [B, ..., C]; target_indices integer [B, ...]."""
    log_p = torch.log_softmax(logits.float(), dim=-1)
    tgt = target_indices.long()
    picked = torch.gather(log_p, -1, tgt[..., None])[..., 0]
    if weight is not None:
        picked = picked * torch.as_tensor(weight, dtype=torch.float32, device=picked.device)[tgt]
    loss = -picked.sum()
    return loss / tgt.numel() if size_average else loss


def binary_dice_loss(
    predict: torch.Tensor, target: torch.Tensor, smooth: float = 1.0, p: int = 2, reduction: str = "mean",
) -> torch.Tensor:
    """Per-sample soft dice on already-activated predictions, flattened over
    everything but the batch: 1 - (Σ pred·t + smooth) / (Σ pred^p + t^p + smooth)."""
    b = predict.shape[0]
    pre, tar = predict.reshape(b, -1).float(), target.reshape(b, -1).float()
    num = (pre * tar).sum(dim=1) + smooth
    den = (pre**p + tar**p).sum(dim=1) + smooth
    loss = 1 - num / den
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"Unexpected reduction {reduction}")


def dice_loss(predict: torch.Tensor, target: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """sigmoid, then soft dice with the intersection and union summed over
    the whole batch: 1 - 2 (Σ σ(x)·t + eps) / (Σ σ(x) + t + eps)."""
    pre = torch.sigmoid(predict.float()).reshape(predict.shape[0], -1)
    tar = target.float().reshape(target.shape[0], -1)
    intersection = (pre * tar).sum(dim=-1).sum()
    union = (pre + tar).sum(dim=-1).sum()
    return 1 - 2 * (intersection + eps) / (union + eps)


def multiclass_dice_loss(
    inputs: torch.Tensor,
    target_indices: torch.Tensor,
    n_classes: int,
    weight: Optional[Sequence[float]] = None,
    softmax: bool = False,
) -> torch.Tensor:
    """One-hot target + per-class soft dice (smooth 1e-5), weighted and
    averaged over the classes.

    inputs [B, ..., C]; target_indices integer [B, ...]."""
    smooth = 1e-5
    x = inputs.float()
    if softmax:
        x = torch.softmax(x, dim=-1)
    onehot = torch.nn.functional.one_hot(target_indices.long(), n_classes).float()
    w = torch.as_tensor([1.0] * n_classes if weight is None else weight, dtype=torch.float32, device=x.device)
    score, tgt = x.reshape(-1, n_classes), onehot.reshape(-1, n_classes)
    intersect = (score * tgt).sum(dim=0)
    y_sum = (tgt * tgt).sum(dim=0)
    z_sum = (score * score).sum(dim=0)
    dice = (2 * intersect + smooth) / (z_sum + y_sum + smooth)
    return ((1 - dice) * w).sum() / n_classes


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Binary focal loss on logits: mean of α_t (1 - p_t)^γ · BCE."""
    x, t = logits.float(), targets.float()
    p = torch.sigmoid(x)
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return (alpha_t * (1 - p_t) ** gamma * _bce_terms(x, t)).mean()
