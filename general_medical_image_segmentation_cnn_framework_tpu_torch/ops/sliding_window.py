"""Sliding-window prediction of a whole volume, on the model's device.

Port of the JAX package's crop-mode path (``ops/sliding_window.py``,
``sliding_window_predict`` with ``overlap_mode='crop'``,
``aggregate='device'``): the volume is uploaded once, tiles on the TorchIO
grid (``data.pipeline.grid_locations``) are gathered on the device in
batches of ``batch_size`` (the last batch padded with repeats of the last
tile, as there), run through the model, argmaxed over channels, and written
into an int8 mask on the device with the border-aware half-overlap crop,
later tiles overwriting. Only the final mask leaves the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..data.pipeline import grid_locations


def prepare_volume(volume: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Host [C, X, Y, Z] -> [X, Y, Z, C] on ``device`` in ``dtype``."""
    vol = np.ascontiguousarray(np.moveaxis(np.asarray(volume, dtype=np.float32), 0, -1))
    return torch.from_numpy(vol).to(device=device, dtype=dtype)


def _crop_box(start: Sequence[int], patch: Sequence[int], spatial: Sequence[int], half):
    """Per axis, the [lo, hi) range of a tile kept by the crop: half the
    overlap is trimmed from each side that does not touch the border."""
    box = []
    for s, p, size, c in zip(start, patch, spatial, half):
        lo = 0 if s == 0 else c
        hi = p if s + p == size else p - c
        box.append((lo, hi))
    return box


@torch.inference_mode()
def sliding_window_predict(
    model: Callable[[torch.Tensor], torch.Tensor],
    volume: torch.Tensor,
    patch_size: Sequence[int],
    patch_overlap: Sequence[int],
    batch_size: int,
) -> torch.Tensor:
    """Crop-mode sliding-window argmax mask of ``volume``.

    model:  eval-mode module (or ``models.make_forward``'s 2-D adapter of one),
            tiles [B, pX, pY, pZ, C] -> logits [..., n_classes].
    volume: [X, Y, Z, C] on the model's device (``prepare_volume``).
    Returns an int8 [X, Y, Z] mask on the same device."""
    patch = tuple(int(p) for p in patch_size)
    spatial = tuple(volume.shape[:3])
    half = tuple(int(o) // 2 for o in patch_overlap)
    starts = grid_locations(spatial, patch, patch_overlap)[:, :3].tolist()
    starts += [starts[-1]] * (-len(starts) % batch_size)
    out = torch.zeros(spatial, dtype=torch.int8, device=volume.device)
    for b0 in range(0, len(starts), batch_size):
        chunk = starts[b0 : b0 + batch_size]
        tiles = torch.stack(
            [volume[x : x + patch[0], y : y + patch[1], z : z + patch[2]] for x, y, z in chunk]
        )
        masks = model(tiles).argmax(dim=-1).to(torch.int8)
        for mask, start in zip(masks, chunk):
            (x0, x1), (y0, y1), (z0, z1) = _crop_box(start, patch, spatial, half)
            x, y, z = start
            out[x + x0 : x + x1, y + y0 : y + y1, z + z0 : z + z1] = mask[x0:x1, y0:y1, z0:z1]
    return out
