"""One-pass BCE-with-logits + dice counts and its gradient, for the binary
segmentation train step.

``fused_bce_dice_metrics(logits, gt)`` has the contract of the JAX package's
``ops/fused.fused_bce_dice_metrics``: the loss equals
``bce_with_logits(logits, one_hot_background(gt))`` and (jaccard, dice)
equal ``metrics.dice_jaccard(gt > 0, argmax(logits))``; the one-hot target
is never built. The forward is one call of ``bce_dice_sums`` and the
backward one call of ``bce_dice_grads`` (a ``torch.autograd.Function``; gt
gets no gradient). On a CUDA tensor each runs its hand-written kernel
(``csrc/fused_bce_dice.cu``, which replaces the Pallas kernels
``ops/fused._pallas_sums`` and ``_pallas_grads``) and adds one to its
``launches``; a failed build or launch raises. On a CPU tensor each runs
its plain PyTorch version (``*_reference``), which is also the kernels'
oracle in the tests and in ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

def _bce(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def bce_dice_sums_reference(logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 [loss sum, intersection, gt sum, pred sum] over
    logits [..., 2] and gt [..., 1]."""
    l0, l1 = logits[..., 0].float(), logits[..., 1].float()
    g = gt[..., 0].float()
    pred = (l1 > l0).float()
    fg = (g > 0).float()
    loss = _bce(l0, 1.0 - g) + _bce(l1, g)
    return torch.stack([loss.sum(), (pred * fg).sum(), fg.sum(), pred.sum()])


def bce_dice_grads_reference(logits: torch.Tensor, gt: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: d loss_sum / d logits times ``scale`` (f32 [1]):
    (sigmoid(l0) - (1 - g), sigmoid(l1) - g) * scale."""
    g = gt.float()
    target = torch.cat([1.0 - g, g], dim=-1)
    return (torch.sigmoid(logits.float()) - target) * scale.float()


def _check(logits: torch.Tensor, gt: torch.Tensor) -> None:
    if logits.dtype != torch.float32 or gt.dtype != torch.float32:
        raise TypeError(f"bce_dice: logits and gt must be float32, got {logits.dtype}, {gt.dtype}")
    if logits.dim() < 2 or logits.shape[-1] != 2 or logits.numel() == 0:
        raise ValueError(f"bce_dice: logits must be a non-empty [..., 2], got {tuple(logits.shape)}")
    if tuple(gt.shape) != tuple(logits.shape[:-1]) + (1,):
        raise ValueError(
            f"bce_dice: gt must be {tuple(logits.shape[:-1]) + (1,)}, got {tuple(gt.shape)}"
        )
    if not (logits.is_contiguous() and gt.is_contiguous()):
        raise ValueError("bce_dice: logits and gt must be contiguous")
    if logits.device != gt.device:
        raise ValueError(f"bce_dice: logits and gt must share a device, got {logits.device}, {gt.device}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bce_dice: unsupported device {logits.device}")


@functools.cache
def _lib():
    lib = _build.load("fused_bce_dice")
    lib.bce_dice_workspace_bytes.argtypes = [ctypes.c_longlong]
    lib.bce_dice_workspace_bytes.restype = ctypes.c_longlong
    lib.bce_dice_sums_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.bce_dice_sums_launch.restype = ctypes.c_int
    lib.bce_dice_grads_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.bce_dice_grads_launch.restype = ctypes.c_int
    return lib


def _device_args(t: torch.Tensor):
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(t.device).cuda_stream


def bce_dice_sums(logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """f32 [4]: [loss sum, intersection, gt sum, pred sum]. logits [..., 2]
    and gt [..., 1] float32 (the model's logits are float32). A CUDA tensor runs the sums
    kernel and adds one to ``bce_dice_sums.launches``."""
    _check(logits, gt)
    if logits.device.type == "cpu":
        return bce_dice_sums_reference(logits, gt)
    v = logits.numel() // 2
    lib = _lib()
    out = torch.empty(4, dtype=torch.float32, device=logits.device)
    ws = torch.empty(lib.bce_dice_workspace_bytes(v), dtype=torch.uint8, device=logits.device)
    err = lib.bce_dice_sums_launch(
        logits.data_ptr(), gt.data_ptr(), out.data_ptr(), ws.data_ptr(), v, *_device_args(logits),
    )
    if err != 0:
        raise RuntimeError(f"bce_dice_sums: CUDA launch failed with cudaError {err}")
    bce_dice_sums.launches += 1
    return out


bce_dice_sums.launches = 0


def bce_dice_grads(logits: torch.Tensor, gt: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """d loss_sum / d logits times ``scale``, a float32 [1] tensor on logits'
    device, float32. A CUDA tensor runs the grads kernel and adds
    one to ``bce_dice_grads.launches``."""
    _check(logits, gt)
    if scale.dtype != torch.float32 or scale.numel() != 1 or scale.device != logits.device:
        raise ValueError(f"bce_dice_grads: scale must be a float32 [1] on {logits.device}")
    if logits.device.type == "cpu":
        return bce_dice_grads_reference(logits, gt, scale)
    scale = scale.reshape(1).contiguous()
    d = torch.empty_like(logits)
    err = _lib().bce_dice_grads_launch(
        logits.data_ptr(), gt.data_ptr(), scale.data_ptr(), d.data_ptr(), logits.numel() // 2,
        *_device_args(logits),
    )
    if err != 0:
        raise RuntimeError(f"bce_dice_grads: CUDA launch failed with cudaError {err}")
    bce_dice_grads.launches += 1
    return d


bce_dice_grads.launches = 0


class _BceDiceSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, gt):
        ctx.save_for_backward(logits, gt)
        return bce_dice_sums(logits, gt)

    @staticmethod
    def backward(ctx, grad_sums):
        # only the loss sum is differentiable; the counts are step functions
        logits, gt = ctx.saved_tensors
        return bce_dice_grads(logits, gt, grad_sums[:1].float()), None


def fused_bce_dice_metrics(
    logits: torch.Tensor, gt: torch.Tensor, smooth: float = 0.001
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, jaccard, dice) for binary segmentation, as 0-d f32 tensors.

    logits: [B, ..., 2] raw outputs; gt: [B, ..., 1] binary foreground."""
    sums = _BceDiceSums.apply(logits.contiguous(), gt.float().contiguous())
    loss = sums[0] / (2.0 * (logits.numel() // 2))
    inter, g_sum, p_sum = sums[1], sums[2], sums[3]
    jaccard = inter / (g_sum + p_sum - inter + smooth)
    dice = 2.0 * inter / (g_sum + p_sum + smooth)
    return loss, jaccard, dice
