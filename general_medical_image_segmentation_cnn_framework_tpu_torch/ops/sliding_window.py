"""Sliding-window and whole-volume prediction of a volume, on the model's device.

Port of the JAX package's ``ops/sliding_window.py``. ``sliding_window_predict``
uploads nothing itself: the volume is on the device already
(``prepare_volume``). The tiles on the TorchIO grid
(``data.pipeline.grid_locations`` over the true extent ``true_spatial``
when the volume is padded beyond it, so that bucketed and unbucketed
predictions are the same bytes) are gathered in batches of ``batch_size``
by one indexed gather a batch (the last batch padded with repeats of the
last tile, as there), run through the model, and aggregated by
``overlap_mode``:

* ``crop`` (default): the argmax of each tile, written into an int8 mask on
  the device with the border-aware half-overlap crop, later tiles
  overwriting (TorchIO's aggregation, byte for byte);
* ``mean_logits``: the f32 logits and a per-voxel count summed on the
  device (the padded repeats get weight 0), the argmax of
  ``acc / max(cnt, 1)`` taken once;
* any other mode (``average``): the tiles' argmax masks go to the host
  ``GridAggregator``, as in the JAX package.

``whole_volume_predict`` pads the volume on the device to a multiple of
``pad_multiple``, runs one forward at batch 1, takes the argmax and crops
back to the volume's extent.

With ``sync=False`` (a host-aggregated mode always) both return a thunk:
the device work and the copy of the result into pinned host memory are
enqueued, in that order, on the current stream, with an event behind the
copy; the thunk waits on that event, so a copy never waits for kernels
queued after it (the next volume's). The mask crosses as int8:
bit-packing it, as the JAX package does for a TPU's link, costs more on
the host than it saves over a card's PCIe link (``chip_smoke.py`` [13]
times both). ``on_dispatch`` is called once everything is enqueued:
predict's loader thread starts the next volume's upload then.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.pipeline import GridAggregator, grid_locations


def prepare_volume(volume: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Host [C, X, Y, Z] -> [X, Y, Z, C] on ``device`` in ``dtype``; to a card
    through pinned memory, without blocking the calling thread."""
    vol = torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(volume, dtype=np.float32), 0, -1)))
    if device.type == "cuda":
        vol = vol.pin_memory()
    return vol.to(device=device, dtype=dtype, non_blocking=True)


def pad_volume(volume: torch.Tensor, multiple: int) -> torch.Tensor:
    """[X, Y, Z, C] zero-padded at the high end of each spatial axis to a
    multiple of ``multiple``, on its device (itself if nothing to pad)."""
    pads = [-(-s // multiple) * multiple - s for s in volume.shape[:3]]
    if not any(pads):
        return volume
    return F.pad(volume, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))


def _deferred(result: torch.Tensor, finish: Callable[[np.ndarray], np.ndarray]) -> Callable:
    """Enqueue the copy of ``result`` to the host right behind the kernels
    that make it; return a thunk that waits for that copy alone and returns
    ``finish`` of the host array."""
    done = None
    if result.device.type == "cuda":
        host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
        host.copy_(result, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    else:
        host = result

    def fetch() -> np.ndarray:
        if done is not None:
            done.synchronize()
        return finish(host.numpy())

    return fetch


def _as_mask(mask: np.ndarray) -> np.ndarray:
    """[X, Y, Z] host mask -> the JAX package's [1, X, Y, Z] int32."""
    return mask[None].astype(np.int32)


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
    overlap_mode: str = "crop",
    true_spatial: Optional[Sequence[int]] = None,
    on_dispatch: Optional[Callable[[], None]] = None,
    sync: bool = True,
):
    """Sliding-window prediction of ``volume``.

    model:  eval-mode module (or ``models.make_forward``'s 2-D adapter of one,
            or ``predict.wrap_tta`` of either), tiles [B, pX, pY, pZ, C] ->
            logits [..., n_classes].
    volume: [X, Y, Z, C] on the model's device (``prepare_volume``), padded
            beyond its true extent ``true_spatial`` if that is given.
    sync=True returns, for ``crop`` and ``mean_logits``, the int8 [X, Y, Z]
    mask on the volume's device. sync=False, and a host-aggregated mode
    always, return a thunk of the host result in the JAX package's form:
    [1, X, Y, Z], int32 for a mask, the ``GridAggregator``'s float64 for a
    host-aggregated mode."""
    patch = tuple(int(p) for p in patch_size)
    spatial = tuple(int(s) for s in (true_spatial if true_spatial is not None else volume.shape[:3]))
    half = tuple(int(o) // 2 for o in patch_overlap)
    locations = grid_locations(spatial, patch, patch_overlap)
    n = len(locations)
    starts = locations[:, :3].tolist()
    starts += [starts[-1]] * (-n % batch_size)
    # one gather a batch: per tile and axis the voxel indices start + arange(p)
    dev = volume.device
    idx = torch.as_tensor(starts, dtype=torch.long, device=dev)
    ix, iy, iz = (idx[:, d, None] + torch.arange(patch[d], device=dev) for d in range(3))
    ix, iy, iz = ix[:, :, None, None], iy[:, None, :, None], iz[:, None, None, :]

    device_modes = ("crop", "mean_logits")
    out = acc = cnt = None
    tile_masks = []
    for b0 in range(0, len(starts), batch_size):
        b1 = b0 + batch_size
        logits = model(volume[ix[b0:b1], iy[b0:b1], iz[b0:b1]])
        if overlap_mode == "mean_logits":
            if acc is None:
                acc = torch.zeros((*spatial, logits.shape[-1]), dtype=torch.float32, device=dev)
                cnt = torch.zeros(spatial, dtype=torch.float32, device=dev)
            logits = logits.float()
            for i in range(b0, min(b1, n)):  # the padded repeats weigh 0: they add nothing
                x, y, z = starts[i]
                box = (slice(x, x + patch[0]), slice(y, y + patch[1]), slice(z, z + patch[2]))
                acc[box] += logits[i - b0]
                cnt[box] += 1.0
            continue
        masks = logits.argmax(dim=-1).to(torch.int8)
        if overlap_mode != "crop":
            tile_masks.append(masks[: n - b0])
            continue
        if out is None:
            out = torch.zeros(spatial, dtype=torch.int8, device=dev)
        for mask, start in zip(masks, starts[b0:b1]):
            (x0, x1), (y0, y1), (z0, z1) = _crop_box(start, patch, spatial, half)
            x, y, z = start
            out[x + x0 : x + x1, y + y0 : y + y1, z + z0 : z + z1] = mask[x0:x1, y0:y1, z0:z1]
    if overlap_mode == "mean_logits":
        out = (acc / cnt.clamp_min(1.0)[..., None]).argmax(dim=-1).to(torch.int8)

    if overlap_mode in device_modes:
        result = out if sync else _deferred(out, _as_mask)
    else:
        def aggregate(all_masks: np.ndarray) -> np.ndarray:
            aggregator = GridAggregator(
                spatial, patch_overlap, overlap_mode=overlap_mode, num_channels=1, dtype=np.int32,
            )
            aggregator.add_batch(all_masks[:, None].astype(np.int32), locations)
            return aggregator.get_output_tensor()

        result = _deferred(torch.cat(tile_masks), aggregate)
    if on_dispatch is not None:
        on_dispatch()
    return result


@torch.inference_mode()
def whole_volume_predict(
    model: Callable[[torch.Tensor], torch.Tensor],
    volume: torch.Tensor,
    pad_multiple: int = 16,
    on_dispatch: Optional[Callable[[], None]] = None,
    sync: bool = True,
):
    """One forward over the whole volume, no tiling.

    ``volume`` [X, Y, Z, C] on the model's device is zero-padded on the
    device to a multiple of ``pad_multiple`` (the network's downsampling
    factor; ``lcm(pad_multiple, shape_bucket)`` under bucketing), run at
    batch 1 and argmaxed; the mask is cropped back to [X, Y, Z]. sync=True
    returns it as int8 on the device; sync=False a thunk of the host
    [1, X, Y, Z] int32 mask."""
    spatial = tuple(volume.shape[:3])
    x = pad_volume(volume, pad_multiple)
    logits = model(x[None])
    mask = logits[0].argmax(dim=-1).to(torch.int8)
    if sync:
        result = mask[: spatial[0], : spatial[1], : spatial[2]]
    else:
        result = _deferred(mask, lambda m: _as_mask(m[: spatial[0], : spatial[1], : spatial[2]]))
    if on_dispatch is not None:
        on_dispatch()
    return result
