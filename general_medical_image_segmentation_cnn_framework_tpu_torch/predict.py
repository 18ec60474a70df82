"""Prediction entry point: sliding-window whole-volume inference.

Same CLI, run-dir layout and outputs as the JAX package's ``predict.py``:
per volume, z-normalisation -> crop-mode sliding window over the TorchIO
grid (``patch_overlap`` 4,4,36 by default) -> argmax mask written as
``pred_file/pred-%04d{.nii.gz|.mhd}`` with the source's affine ->
(precision, recall, jaccard, dice, hd95) -> ``metrics.csv`` with a mean row::

    python -m general_medical_image_segmentation_cnn_framework_tpu_torch.predict \\
        config=unet config.ckpt=<port checkpoint .pt>

A 2-D network (``config=unet2d``, patch "1, H, W") runs on each tile's one
slice through ``models.make_forward``'s adapter; the overlap of the depth
axis is then clamped to 0.

The model runs on the CUDA card unless ``config.platform=cpu``; without a
card and without that it raises instead of falling back to the CPU. On the
card every eval ConvBlock is the hand-written kernel. Volumes go through one
at a time. The checkpoint may be a weights-only file or one written by
``train``: predict reads its ``params``.
"""

from __future__ import annotations

import csv
import math
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .checkpoint import load_checkpoint
from .config import compose, log_ignored_keys, resolve_device
from .data.io import Volume, write_volume
from .data.pipeline import get_subjects, load_subject
from .data.transforms import ZNormalization
from .logging_utils import ProgressBars, get_logger, log_config
from .metrics import multiclass_seg_metrics, seg_metrics
from .models import build_model, make_forward
from .ops.sliding_window import prepare_volume, sliding_window_predict

METRIC_NAMES = ("precision", "recall", "jaccard", "dice", "hs95")


def _overlap(config):
    overlap = config.patch_overlap
    if isinstance(overlap, str):
        overlap = tuple(int(v) for v in overlap.split(","))
    elif isinstance(overlap, int):
        overlap = (overlap,) * 3
    # overlap must stay below the patch extent
    return tuple(min(o, p - 1) for o, p in zip(overlap, config.patch_size))


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
    overlap = _overlap(config)
    forward = make_forward(config, model)
    znorm = ZNormalization()
    progress = ProgressBars()
    file_task = progress.add_task("[red]file", total=len(pairs))

    results = []
    for i, pair in enumerate(pairs):
        subject = load_subject(pair)
        t0 = time.perf_counter()
        vol = prepare_volume(znorm.normalize_array(subject.source.data), device, model.dtype)
        mask = sliding_window_predict(
            forward, vol, config.patch_size, overlap, int(config.batch_size)
        )
        pred = mask.cpu().numpy()[None].astype(np.int32)
        logger.info(f"File {i + 1}: sliding window {time.perf_counter() - t0:.3f} s")
        save_pred(pred, subject.source.affine, i, config)
        if int(config.out_classes) > 2:
            metrics = multiclass_seg_metrics(
                subject.gt.data, pred, int(config.out_classes), subject.source.spacing
            )
        else:
            metrics = seg_metrics(subject.gt.data, pred, subject.source.spacing)
        results.append(tuple(float(v) for v in metrics))
        logger.info(
            f"File {i + 1} metrics: "
            + "".join(f"\n{name}: {v}" for name, v in zip(METRIC_NAMES, results[-1]))
        )
        progress.update(file_task, completed=i + 1)
    progress.stop()

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
