"""One-pass BCE-with-logits + dice metrics and its gradient, for the binary
segmentation train step.

``fused_bce_dice_metrics(logits, gt)`` has the contract of the JAX package's
``ops/fused.fused_bce_dice_metrics``: the loss equals
``bce_with_logits(logits, one_hot_background(gt))`` and (jaccard, dice)
equal ``metrics.dice_jaccard(gt > 0, argmax(logits))``; the one-hot target
is never built. It is a ``torch.autograd.Function`` (gt gets no gradient;
jaccard and dice are not differentiable). On a CUDA tensor its forward is one
launch of the forward kernel, which writes the four sums and the three
metrics, and its backward one launch of the backward kernel, which divides
the loss's cotangent by 2V itself (``csrc/fused_bce_dice.cu``, replacing the
Pallas kernels ``ops/fused._pallas_sums`` and ``_pallas_grads``); nothing
else launches on the card. ``bce_dice_sums`` and ``bce_dice_grads`` are the
same two kernels with the sums alone and with a given scale. Each launch adds
one to ``bce_dice_sums.launches`` (forward) or ``bce_dice_grads.launches``
(backward); a failed build or launch raises. On a CPU tensor each runs its
plain PyTorch version (``*_reference``), which is also the kernels' oracle in
the tests and in ``chip_smoke.py``.
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


def _metrics_reference(sums: torch.Tensor, voxels: int, smooth: float):
    """The epilogue of the JAX package's ``fused_bce_dice_metrics`` on the
    four sums, in f32 and in its order: (loss, jaccard, dice)."""
    inter, g_sum, p_sum = sums[1], sums[2], sums[3]
    loss = sums[0] / (2.0 * voxels)
    jaccard = inter / (g_sum + p_sum - inter + smooth)
    dice = 2.0 * inter / (g_sum + p_sum + smooth)
    return loss, jaccard, dice


def _check(logits: torch.Tensor, gt: torch.Tensor) -> None:
    if logits.dtype != torch.float32 or gt.dtype != torch.float32:
        raise TypeError(f"bce_dice: logits and gt must be float32, got {logits.dtype}, {gt.dtype}")
    if logits.dim() < 2 or logits.shape[-1] != 2 or logits.numel() == 0:
        raise ValueError(f"bce_dice: logits must be a non-empty [..., 2], got {tuple(logits.shape)}")
    if gt.shape[:-1] != logits.shape[:-1] or gt.shape[-1] != 1:
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
    lib.bce_dice_workspace_bytes.argtypes = [ctypes.c_int]
    lib.bce_dice_workspace_bytes.restype = ctypes.c_longlong
    lib.bce_dice_forward_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    lib.bce_dice_forward_launch.restype = ctypes.c_int
    lib.bce_dice_backward_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    lib.bce_dice_backward_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACES = {}


def _launch_args(t: torch.Tensor):
    """(SM count, device index, raw current stream) for a launch on t's card."""
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return _sm_count(index), index, torch._C._cuda_getCurrentRawStream(index)


def _workspace(sms: int, index: int, stream: int) -> torch.Tensor:
    """The forward's partials and ticket for one (device, stream): allocated and
    zeroed at the first eager call, then reused, so an eager call allocates and
    clears nothing. Under CUDA graph capture each call takes a new one from the
    graph's pool, zeroed by a memset that every replay runs: a cached one would
    be shared with eager calls and other graphs, and one first made in a capture
    holds no zeros until the graph is replayed."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(_lib().bce_dice_workspace_bytes(sms), dtype=torch.uint8, device=f"cuda:{index}")
    ws = _WORKSPACES.get((index, stream))
    if ws is None:
        ws = torch.zeros(_lib().bce_dice_workspace_bytes(sms), dtype=torch.uint8, device=f"cuda:{index}")
        _WORKSPACES[(index, stream)] = ws
    return ws


def _forward(logits: torch.Tensor, gt: torch.Tensor, smooth: float) -> torch.Tensor:
    """f32 [7] from one launch: the four sums, loss, jaccard, dice."""
    v = logits.numel() // 2
    sms, index, stream = _launch_args(logits)
    out = torch.empty(7, dtype=torch.float32, device=logits.device)
    err = _lib().bce_dice_forward_launch(
        logits.data_ptr(), gt.data_ptr(), out.data_ptr(), _workspace(sms, index, stream).data_ptr(),
        v, 2.0 * v, smooth, sms, index, stream,
    )
    if err != 0:
        raise RuntimeError(f"bce_dice forward: CUDA launch failed with cudaError {err}")
    _build.count_launch(bce_dice_sums)
    return out


def _backward(logits: torch.Tensor, gt: torch.Tensor, ct: torch.Tensor, denom: float) -> torch.Tensor:
    """The gradient of the loss sum times ct / denom, from one launch."""
    sms, index, stream = _launch_args(logits)
    d = torch.empty_like(logits)
    err = _lib().bce_dice_backward_launch(
        logits.data_ptr(), gt.data_ptr(), ct.data_ptr(), denom, d.data_ptr(), logits.numel() // 2,
        sms, index, stream,
    )
    if err != 0:
        raise RuntimeError(f"bce_dice backward: CUDA launch failed with cudaError {err}")
    _build.count_launch(bce_dice_grads)
    return d


def bce_dice_sums(logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """f32 [4]: [loss sum, intersection, gt sum, pred sum]. logits [..., 2]
    and gt [..., 1] float32 (the model's logits are float32). A CUDA tensor
    runs the forward kernel and adds one to ``bce_dice_sums.launches``."""
    _check(logits, gt)
    if logits.device.type == "cpu":
        return bce_dice_sums_reference(logits, gt)
    return _forward(logits, gt, 0.001)[:4]


bce_dice_sums.launches = 0


def bce_dice_grads(logits: torch.Tensor, gt: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """d loss_sum / d logits times ``scale``, a float32 [1] tensor on logits'
    device, float32. A CUDA tensor runs the backward kernel and adds one to
    ``bce_dice_grads.launches``."""
    _check(logits, gt)
    if scale.dtype != torch.float32 or scale.numel() != 1 or scale.device != logits.device:
        raise ValueError(f"bce_dice_grads: scale must be a float32 [1] on {logits.device}")
    if logits.device.type == "cpu":
        return bce_dice_grads_reference(logits, gt, scale)
    return _backward(logits, gt, scale, 1.0)


bce_dice_grads.launches = 0


class _BceDiceMetrics(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, gt, smooth):
        ctx.save_for_backward(logits, gt)
        ctx.set_materialize_grads(False)  # jaccard and dice get no cotangent: no zeros to fill
        v = logits.numel() // 2
        if logits.device.type == "cpu":
            loss, jaccard, dice = _metrics_reference(bce_dice_sums_reference(logits, gt), v, smooth)
        else:
            out = _forward(logits, gt, smooth)
            loss, jaccard, dice = out[4], out[5], out[6]
        ctx.mark_non_differentiable(jaccard, dice)
        return loss, jaccard, dice

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_loss, _grad_jaccard, _grad_dice):
        if grad_loss is None:
            return None, None, None
        logits, gt = ctx.saved_tensors
        v = logits.numel() // 2
        if logits.device.type == "cpu":
            return bce_dice_grads_reference(logits, gt, (grad_loss / (2.0 * v)).reshape(1)), None, None
        return _backward(logits, gt, grad_loss.float().contiguous(), 2.0 * v), None, None


def fused_bce_dice_metrics(
    logits: torch.Tensor, gt: torch.Tensor, smooth: float = 0.001
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, jaccard, dice) for binary segmentation, as 0-d f32 tensors.

    logits: [B, ..., 2] raw outputs; gt: [B, ..., 1] binary foreground."""
    logits, gt = logits.contiguous(), gt.float().contiguous()
    _check(logits, gt)
    return _BceDiceMetrics.apply(logits, gt, float(smooth))
