"""Prediction entry point: sliding-window or whole-volume inference.

Same CLI, options, run-dir layout and outputs as the JAX package's
``predict.py``: per volume, z-normalisation -> the sliding window over the
TorchIO grid (``patch_overlap`` 4,4,36 by default; ``blend`` crop,
mean_logits or average) or, with ``whole_volume=true``, one forward over
the volume padded to the network's ``pad_multiple`` -> argmax mask written
as ``pred_file/pred-%04d{.nii.gz|.mhd}`` with the source's affine ->
(precision, recall, jaccard, dice, hd95) -> ``metrics.csv`` with a mean
row::

    python -m general_medical_image_segmentation_cnn_framework_tpu_torch.predict \\
        config=unet config.ckpt=<port checkpoint .pt> [config.tta=flips] [config.blend=mean_logits] \\
        [config.whole_volume=true] [config.shape_bucket=32]

``tta`` averages the logits over mirror flips (``wrap_tta``);
``shape_bucket`` pads each volume to a multiple of it, with the tile grid
and crop on the true extent (the masks are unchanged; under
``whole_volume`` the volume is padded to ``lcm(pad_multiple, bucket)``
before the forward, as in the JAX package).

A 2-D network (``config=unet2d``, patch "1, H, W") runs on each tile's one
slice through ``models.make_forward``'s adapter; the overlap of the depth
axis is then clamped to 0, and ``whole_volume`` falls back to the sliding
window with the JAX package's warning.

The loop is pipelined as the JAX package's: a loader thread reads,
z-normalises and uploads the next volume while the card runs the current
one, each volume's mask is fetched only after the next volume's work is
enqueued, and two worker threads write the masks and compute the metrics.
The model runs on the CUDA card unless ``config.platform=cpu``; without a
card and without that it raises instead of falling back to the CPU. On the
card every eval ConvBlock is the hand-written kernel. The checkpoint may
be a weights-only file or one written by ``train``: predict reads its
``params``. The JAX package's multi-device mesh is not carried (one card).
"""

from __future__ import annotations

import csv
import itertools
import math
import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .checkpoint import load_checkpoint
from .config import compose, log_ignored_keys, resolve_device
from .data.io import Volume, write_volume
from .data.pipeline import get_subjects, load_subject
from .data.transforms import ZNormalization
from .logging_utils import ProgressBars, get_logger, log_config
from .metrics import multiclass_seg_metrics, seg_metrics
from .models import build_model, is_2d, make_forward, pad_multiple
from .ops.sliding_window import pad_volume, prepare_volume, sliding_window_predict, whole_volume_predict

METRIC_NAMES = ("precision", "recall", "jaccard", "dice", "hs95")


def overlap_of(config):
    overlap = config.patch_overlap
    if isinstance(overlap, str):
        overlap = tuple(int(v) for v in overlap.split(","))
    elif isinstance(overlap, int):
        overlap = (overlap,) * 3
    # overlap must stay below the patch extent
    return tuple(min(o, p - 1) for o, p in zip(overlap, config.patch_size))


def wrap_tta(config, forward: Callable) -> Callable:
    """Flip-averaged test-time augmentation (``config.tta``), as the JAX
    package's ``wrap_tta``: '' is ``forward`` itself; ``flips`` averages the
    logits over every combination of mirror flips of the spatial axes of
    the tiles [B, D, H, W, C] (8 forwards for a 3-D net, 4 over h and w for
    a 2-D one); ``flips:<subset of dhw>`` over those axes only. The flipped
    tiles run through ``forward`` one combination at a time (memory stays
    that of one forward), each output is flipped back, and the mean is
    summed in f32 and returned in the forward's dtype."""
    spec = str(getattr(config, "tta", "") or "")
    if not spec:
        return forward
    two_d = is_2d(config.network)
    names = {"d": 1, "h": 2, "w": 3}
    if spec == "flips":
        axes = (2, 3) if two_d else (1, 2, 3)
    elif spec.startswith("flips:"):
        sel = spec.split(":", 1)[1]
        bad = [c for c in sel if c not in names]
        if bad or not sel:
            raise KeyError(f"tta='{spec}': axes must be a subset of 'dhw'")
        axes = tuple(names[c] for c in sel)
        if two_d and 1 in axes:
            raise KeyError(
                f"tta='{spec}': 2-D network '{config.network}' has no depth "
                "axis to flip (use flips:hw)"
            )
    else:
        raise KeyError(f"unknown tta '{spec}' ('' | flips | flips:<dhw subset>)")
    combos = [c for r in range(len(axes) + 1) for c in itertools.combinations(axes, r)]

    def tta_forward(tiles: torch.Tensor) -> torch.Tensor:
        total = None
        for combo in combos:
            out = forward(tiles.flip(combo) if combo else tiles)
            out = out.flip(combo) if combo else out
            total = out.float() if total is None else total + out.float()
        return (total / len(combos)).to(out.dtype)

    return tta_forward


def make_forward_fn(config, model) -> Callable:
    """``tiles [B, D, H, W, C] -> logits``: ``models.make_forward`` (the 2-D
    slice adapter where the network is 2-D) wrapped in ``config.tta``."""
    return wrap_tta(config, make_forward(config, model))


def predict(model=None, config=None, logger=None):
    if config is None:
        raise ValueError("predict needs a config")
    if model is None:
        model = build_model(config)
    device = resolve_device(config)
    if logger is None:
        logger = get_logger(config)
    log_ignored_keys(config, logger)
    logger.info(f"predicting on {device} ({torch.cuda.get_device_name(0) if device.type == 'cuda' else 'host CPU'})")

    state = load_checkpoint(config.ckpt)
    try:
        model.load_state_dict(state["params"])
    except RuntimeError as e:
        raise ValueError(
            f"checkpoint {config.ckpt!r} does not match network '{config.network}': {e}"
        ) from e
    model.to(device).eval()

    pairs = get_subjects(config)
    logger.info(f"predicting {len(pairs)} volumes")
    forward = make_forward_fn(config, model)
    overlap = overlap_of(config)
    whole_volume = bool(getattr(config, "whole_volume", False))
    if whole_volume and is_2d(config.network):
        logger.warning(
            f"whole_volume is 3-D only; '{config.network}' is a 2-D "
            "network — falling back to sliding-window prediction"
        )
        whole_volume = False
    # shape bucketing: the volume padded to a multiple of the bucket; the
    # sliding window's grid and crop follow the true extent (the same
    # masks), the whole volume is padded to lcm(pad_multiple, bucket)
    bucket = int(getattr(config, "shape_bucket", 0) or 0)
    wv_pad = pad_multiple(config.network)
    if bucket:
        wv_pad = math.lcm(wv_pad, bucket)
    blend = getattr(config, "blend", "crop") or "crop"
    znorm = ZNormalization()
    progress = ProgressBars()
    file_task = progress.add_task("[red]file", total=len(pairs))

    # The loader thread reads, z-normalises and uploads volume i+1 once
    # volume i's work is enqueued (the semaphore, released by on_dispatch);
    # the main thread enqueues volume i, then fetches volume i-1's mask
    # (whose copy was enqueued right behind its own kernels) and hands it
    # to a worker, which writes it and computes its metrics.
    load_q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
    stop = threading.Event()
    upload = threading.Semaphore(1)

    def put(item) -> None:
        # never block forever once the consumer has left (stop is set)
        while not stop.is_set():
            try:
                load_q.put(item, timeout=0.5)
                return
            except queue_mod.Full:
                continue

    def acquire_upload() -> bool:
        while not stop.is_set():
            if upload.acquire(timeout=0.5):
                return True
        return False

    def loader() -> None:
        try:
            for i, pair in enumerate(pairs):
                if stop.is_set():
                    return
                subject = load_subject(pair)
                src = znorm.normalize_array(subject.source.data)
                if not acquire_upload():
                    return
                vol = prepare_volume(src, device, model.dtype)
                if bucket and not whole_volume:
                    vol = pad_volume(vol, bucket)
                put((i, subject, src.shape[1:], vol))
        except BaseException as exc:
            put(exc)
        finally:
            put(None)

    def finish(i, pred, subject):
        save_pred(pred, subject.source.affine, i, config)
        if int(config.out_classes) > 2:
            return multiclass_seg_metrics(
                subject.gt.data, pred, int(config.out_classes), subject.source.spacing
            )
        return seg_metrics(subject.gt.data, pred, subject.source.spacing)

    results = [None] * len(pairs)
    loading = threading.Thread(target=loader, name="predict-loader", daemon=True)
    loading.start()
    try:
        with ThreadPoolExecutor(max_workers=2, thread_name_prefix="predict-writer") as pool:
            futures = {}

            def drain(pending) -> None:
                i, thunk, subject = pending
                futures[i] = pool.submit(finish, i, thunk(), subject)
                progress.update(file_task, completed=i + 1)

            pending = None
            while True:
                item = load_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                i, subject, true_shape, vol = item
                if whole_volume:
                    thunk = whole_volume_predict(
                        forward, vol, pad_multiple=wv_pad, on_dispatch=upload.release, sync=False
                    )
                else:
                    thunk = sliding_window_predict(
                        forward, vol, config.patch_size, overlap, int(config.batch_size),
                        overlap_mode=blend, true_spatial=true_shape if bucket else None,
                        on_dispatch=upload.release, sync=False,
                    )
                del vol
                if pending is not None:
                    drain(pending)
                pending = (i, thunk, subject)
            if pending is not None:
                drain(pending)
            for i, fut in futures.items():
                results[i] = tuple(float(v) for v in fut.result())
    finally:
        stop.set()  # unblocks the loader if the loop left early
        loading.join()
        progress.stop()

    for i, row in enumerate(results):
        logger.info(
            f"File {i + 1} metrics: "
            + "".join(f"\n{name}: {v}" for name, v in zip(METRIC_NAMES, row))
        )
    columns = {name: [r[c] for r in results] for c, name in enumerate(METRIC_NAMES)}
    save_csv(*columns.values(), config)
    logger.info(
        "".join(f"\n{name}_mean: {_finite_mean(v)}" for name, v in columns.items())
    )
    return columns


def save_pred(pred: np.ndarray, affine: np.ndarray, index: int, config) -> None:
    """``pred_file/pred-%04d`` with the configured suffix."""
    save_base = Path(config.hydra_path) / "pred_file"
    save_base.mkdir(parents=True, exist_ok=True)
    suffix = getattr(config, "save_suffix", ".nii.gz") or ".nii.gz"
    write_volume(save_base / f"pred-{index:04d}{suffix}", Volume(pred.astype(np.float32), affine))


def _finite_mean(values) -> float:
    """Mean over finite entries: hd95 is inf where a mask has no surface."""
    arr = np.asarray(values, dtype=np.float64)
    finite = arr[np.isfinite(arr)]
    return float(finite.mean()) if finite.size else float("nan")


def save_csv(pre_ls, rec_ls, jac_ls, dice_ls, hs95_ls, config) -> None:
    """``metrics.csv``: the five metric columns, one row per volume, and a
    row of finite means: the file the JAX package writes with pandas
    (NaN as an empty cell, newline line ends)."""
    columns = (pre_ls, rec_ls, jac_ls, dice_ls, hs95_ls)
    rows = [*zip(*columns), [_finite_mean(c) for c in columns]]
    with open(os.path.join(config.hydra_path, "metrics.csv"), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(METRIC_NAMES)
        for row in rows:
            writer.writerow(["" if math.isnan(v) else float(v) for v in row])


def main(argv: Optional[list] = None) -> None:
    """CLI: ``python -m <package>.predict config=unet config.ckpt=<path>``."""
    import sys

    overrides = argv if argv is not None else sys.argv[1:]
    config = compose(overrides, job_name="predict")
    if not config.ckpt:
        raise ValueError("config.ckpt is required for predict")
    model = build_model(config)
    logger = get_logger(config)
    log_config(logger, config)
    predict(model, config, logger)


if __name__ == "__main__":
    main()
