#!/usr/bin/env python3
"""Times the PyTorch port's predict entry point end to end on one CUDA card.

    python3 scripts/bench_torch_predict.py [ROOT ...]

on a machine with a CUDA card and ``nvcc``. Each ROOT is a checkout of the
repository (default: the one that holds this script); each is measured in a
process of its own, in the order given, so two versions compare in one call
on one card (``ROOT_A ROOT_B ROOT_B ROOT_A``). The volumes and the
checkpoint are made once, by this checkout's ``chip_smoke.py`` helpers:
``chip_smoke.py`` [3]'s two synthetic 256x256x128 volumes and its seeded
full-width UNet3D (f=32), as a port checkpoint.

For each ROOT it prints the seconds a volume of ``predict.main`` at
``config=unet`` (bf16, patch 64^3, overlap 4,4,36, batch 16) over both
volumes, the host clock around the call after the kernels are built; for
the first ROOT also the host's own work for one volume, each step alone:
reading the volume and its label, the z-normalisation, writing the mask
(``predict.save_pred``) and the metrics (``metrics.seg_metrics``:
precision, recall, jaccard, dice, HD95) of the mask ``predict.main`` wrote.
The first line is the card's name and power limit. It imports nothing of
JAX.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def measure(root: str, work: Path, host_steps: bool) -> None:
    import torch

    smoke = _smoke()
    sys.path.insert(0, root)
    from general_medical_image_segmentation_cnn_framework_tpu_torch import metrics, predict
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io, pipeline, transforms
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import _build

    def argv(data, out):
        return ["config=unet", f"config.pred_data_path={data / 'source'}", f"config.pred_gt_path={data / 'label'}",
                f"config.output_dir={out}", f"config.ckpt={work / 'unet3d.pt'}",
                f"config.patch_size={smoke.PATCH}, {smoke.PATCH}, {smoke.PATCH}",
                "config.patch_overlap=" + ", ".join(map(str, smoke.OVERLAP)), f"config.batch_size={smoke.BATCH}",
                "config.precision=bfloat16"]

    print(f"== {root}", flush=True)
    out = Path(tempfile.mkdtemp(prefix="bench_predict-", dir=work))
    _build.load("conv3d_bn_relu")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict.main(argv(work / "data", out / "runs"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"predict.main: {wall / smoke.N_VOLUMES:.3f} s per volume end to end over {smoke.N_VOLUMES} volumes",
          flush=True)
    if not host_steps:
        return
    (run,) = (out / "runs").glob("predict-*/*")
    pair = (work / "data" / "source" / "vol-00.nii.gz", work / "data" / "label" / "vol-00.nii.gz")
    pred = io.read_volume(run / "pred_file" / "pred-0000.nii.gz").data.astype(np.int32)
    config = compose(argv(work / "data", out / "host"), job_name="predict")
    steps = {
        "read volume and label": lambda: pipeline.load_subject(pair),
        "z-normalise": lambda: transforms.ZNormalization().normalize_array(subject.source.data),
        "write the mask": lambda: predict.save_pred(pred, subject.source.affine, 0, config),
        "metrics (HD95 included)": lambda: metrics.seg_metrics(subject.gt.data, pred, subject.source.spacing),
    }
    subject = pipeline.load_subject(pair)
    times = {}
    for name, fn in steps.items():
        t0 = time.perf_counter()
        fn()
        times[name] = time.perf_counter() - t0
    print("host work for one volume: " + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; sum {sum(times.values()):.3f} s; mask foreground {pred.mean():.4f}", flush=True)


def main() -> None:
    if len(sys.argv) >= 5 and sys.argv[1] == "--one":
        measure(sys.argv[2], Path(sys.argv[3]), sys.argv[4] == "1")
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_predict: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    smoke = _smoke()
    sys.path.insert(0, str(HERE))
    from general_medical_image_segmentation_cnn_framework_tpu_torch import checkpoint
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D

    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="bench_predict-", dir=HERE / "build"))
    smoke.write_volumes(work / "data", io)
    checkpoint.save_checkpoint(work / "unet3d.pt", smoke.random_state_dict(torch, UNet3D(1, 2, 32), smoke.SEED),
                               epoch=0)
    roots = sys.argv[1:] or [str(HERE)]
    try:
        for i, root in enumerate(roots):
            subprocess.run([sys.executable, __file__, "--one", str(Path(root).resolve()), str(work), str(int(i == 0))],
                           check=True)
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
