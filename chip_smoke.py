#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card and ``nvcc``. It
imports nothing of JAX. Without a card, or without the repository beside
it, it exits non-zero and prints no result. Phases, each of which stops the
run with a non-zero exit when it fails:

1. The card's name and power limit (``nvidia-smi``); the CUDA kernel is
   built from ``csrc/`` of the port.
2. Kernel vs plain version (``conv3d_bn_relu_reference``, f32 cuDNN with
   TF32 off) at each of UNet3D's 18 conv shapes at patch 64^3, batch 16,
   with random BatchNorm folded in, in bfloat16 and float32. Tolerances,
   relative to max(1, max|plain|): 1e-4 in f32 (summation order only);
   1e-2 in bf16 against the f32 plain result from the same bf16 inputs
   (one bf16 rounding of the output). Times with CUDA events.
3. The port's predict entry point (``predict.main``, config=unet,
   bfloat16, patch 64^3, overlap 4,4,36, batch 16) at full width
   (init_features=32, seeded random weights) on two synthetic 256x256x128
   volumes. The kernel's launch count must be 18 per forward batch.
4. The model on the card (kernel) vs the same module on the CPU (plain),
   f32, one batch of two 64^3 tiles: logits and mask agreement.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PORT = "general_medical_image_segmentation_cnn_framework_tpu_torch"
PATCH = 64
BATCH = 16
VOLUME = (256, 256, 128)
N_VOLUMES = 2
OVERLAP = (4, 4, 36)
LEVELS = (0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 3, 3, 2, 2, 1, 1, 0, 0)  # pooling depth of ConvBlock_i
F32_TOL, BF16_TOL = 1e-4, 1e-2
SEED = 0


def cuda_ms(torch, fn, reps=10):
    """Mean time of one call on the card, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def random_state_dict(torch, model, seed):
    """Seeded weights: fan-in scaled kernels, and BatchNorm statistics and
    affine parameters that make folding far from the identity."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, shape)
        elif name.endswith("bn.weight"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "head.weight":  # nn.Linear [Cout, Cin]
            v = rng.normal(0.0, math.sqrt(1.0 / shape[1]), shape)
        elif name.endswith("weight"):  # conv and up-conv kernels [..., Cin, Cout]
            v = rng.normal(0.0, math.sqrt(2.0 / np.prod(shape[:-1])), shape)
        else:  # biases, BN shifts and running means
            v = rng.normal(0.0, 0.1, shape)
        sd[name] = torch.from_numpy(v.astype(np.float32))
    return sd


def write_volumes(root, io):
    """Bright-ball volumes: label = ball, image = 2*label + N(0, 0.3)."""
    for split in ("source", "label"):
        (root / split).mkdir(parents=True)
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in VOLUME], indexing="ij"))
    for i in range(N_VOLUMES):
        rng = np.random.default_rng(SEED + 100 + i)
        center = rng.uniform(0.3, 0.7, 3) * np.asarray(VOLUME)
        radius = rng.uniform(20, 40)
        label = (np.sqrt(((grid - center[:, None, None, None]) ** 2).sum(0)) < radius).astype(np.float32)
        image = label * 2.0 + rng.normal(0, 0.3, VOLUME).astype(np.float32)
        io.write_nifti(root / "source" / f"vol-{i:02d}.nii.gz", io.Volume(image[None]))
        io.write_nifti(root / "label" / f"vol-{i:02d}.nii.gz", io.Volume(label[None]))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the port on a card")
    sys.path.insert(0, str(ROOT))
    from general_medical_image_segmentation_cnn_framework_tpu_torch import checkpoint, predict
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io, pipeline, transforms
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import _build as build
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu as conv
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import sliding_window as sw

    kernel, plain = conv.conv3d_bn_relu, conv.conv3d_bn_relu_reference
    check("jax" not in sys.modules, "the port imported jax")

    # -- 1. card and build ---------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.load("conv3d_bn_relu")
    print(f"[1] conv3d_bn_relu built in {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 2. kernel vs plain at the 18 UNet3D conv shapes ------------------------
    model = UNet3D(1, 2, 32, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    max_err = 0.0
    totals = {torch.bfloat16: [0.0, 0.0, 0.0], torch.float32: [0.0, 0.0, 0.0]}
    for i, block in enumerate(model.blocks):
        cin, cout = block.conv.weight.shape[3:]
        s = PATCH >> LEVELS[i]
        x = randn(BATCH, s, s, s, cin)
        w, b = conv.fold_batchnorm(
            randn(3, 3, 3, cin, cout) * (27 * cin) ** -0.5, 0.1 * randn(cout),
            0.5 + torch.rand(cout, device=dev, generator=gen), 0.1 * randn(cout),
            0.1 * randn(cout), 0.5 + 1.5 * torch.rand(cout, device=dev, generator=gen),
        )
        line = f"[2] ConvBlock_{i:<2d} {cin:>3d}->{cout:<3d} {BATCH}x{s}^3"
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            xd, wd = x.to(dtype), w.to(dtype)
            got = kernel(xd, wd, b)
            torch.cuda.synchronize()
            want = plain(xd.float(), wd.float(), b)
            err = (got.float() - want).abs().max().item()
            bound = tol * max(1.0, want.abs().max().item())
            check(got.dtype == dtype and got.shape == want.shape, f"ConvBlock_{i} {dtype}: dtype/shape")
            check(err <= bound, f"ConvBlock_{i} {dtype}: max|kernel-plain| {err} > {bound}")
            max_err = max(max_err, err)
            k_ms = cuda_ms(torch, lambda: kernel(xd, wd, b))
            p_ms = cuda_ms(torch, lambda: plain(xd, wd, b))
            # cuDNN in the working dtype, as a library yardstick
            xc, wc = xd.permute(0, 4, 1, 2, 3), wd.permute(4, 3, 0, 1, 2).contiguous()
            c_ms = cuda_ms(torch, lambda: torch.relu(torch.nn.functional.conv3d(xc, wc, b.to(dtype), padding=1)))
            for j, v in enumerate((k_ms, p_ms, c_ms)):
                totals[dtype][j] += v
            line += f" | {str(dtype)[6:]} err {err:.3g} kernel {k_ms:.3f} ms plain {p_ms:.3f} ms cudnn {c_ms:.3f} ms"
            del got, want, xd, wd
        print(line, flush=True)
        del x
    for dtype, (k, p, c) in totals.items():
        print(f"[2] sum of 18 convs, one forward batch, {str(dtype)[6:]}: kernel {k:.3f} ms, "
              f"plain {p:.3f} ms, cudnn {c:.3f} ms", flush=True)

    # -- 3. predict through the entry point ------------------------------------
    work = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        write_volumes(work / "data", io)
        ckpt = work / "unet3d.pt"
        checkpoint.save_checkpoint(ckpt, random_state_dict(torch, UNet3D(1, 2, 32), SEED), epoch=0)
        print(f"[3] wrote {N_VOLUMES} volumes {VOLUME} and a checkpoint in {time.perf_counter() - t0:.1f} s",
              flush=True)
        n_tiles = len(pipeline.grid_locations(VOLUME, (PATCH,) * 3, OVERLAP))
        batches = N_VOLUMES * -(-n_tiles // BATCH)
        argv = [
            "config=unet",
            f"config.pred_data_path={work / 'data' / 'source'}",
            f"config.pred_gt_path={work / 'data' / 'label'}",
            f"config.output_dir={work / 'runs'}",
            f"config.ckpt={ckpt}",
            f"config.patch_size={PATCH}, {PATCH}, {PATCH}",
            "config.patch_overlap=" + ", ".join(map(str, OVERLAP)),
            f"config.batch_size={BATCH}",
            "config.precision=bfloat16",
        ]
        kernel.launches = 0
        t0 = time.perf_counter()
        predict.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel.launches
        check(launches == 18 * batches,
              f"kernel launches {launches} != 18 x {batches} forward batches")
        (run,) = (work / "runs").glob("predict-*/*")
        rows = (run / "metrics.csv").read_text().splitlines()
        check(rows[0] == "precision,recall,jaccard,dice,hs95" and len(rows) == N_VOLUMES + 2,
              f"metrics.csv: {rows}")
        for row in rows[1:-1]:
            vals = [float(v) for v in row.split(",")]
            check(all(0.0 <= v <= 1.0 for v in vals[:4]), f"metrics row out of range: {row}")
        masks = sorted((run / "pred_file").glob("pred-*.nii.gz"))
        check(len(masks) == N_VOLUMES, f"masks written: {masks}")
        mask = io.read_volume(masks[0]).data
        check(mask.shape == (1, *VOLUME) and set(np.unique(mask).tolist()) <= {0.0, 1.0},
              f"mask {mask.shape} {np.unique(mask)[:5]}")
        print(f"[3] predict.main: {N_VOLUMES} volumes, {n_tiles} tiles each, {batches} forward batches, "
              f"{launches} kernel launches, {wall / N_VOLUMES:.3f} s per volume end to end; "
              f"metrics {rows[1:]}", flush=True)

        # the device part alone: sliding window on an uploaded volume, warm
        net = UNet3D(1, 2, 32, dtype=torch.bfloat16)
        net.load_state_dict(checkpoint.load_checkpoint(ckpt)["params"])
        net.to(dev).eval()
        subject = pipeline.load_subject(
            (work / "data" / "source" / "vol-00.nii.gz", work / "data" / "label" / "vol-00.nii.gz")
        )
        src = transforms.ZNormalization().normalize_array(subject.source.data)
        vol = sw.prepare_volume(src, dev, torch.bfloat16)
        sw.sliding_window_predict(net, vol, (PATCH,) * 3, OVERLAP, BATCH)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sw.sliding_window_predict(net, vol, (PATCH,) * 3, OVERLAP, BATCH)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"[3] sliding window on the card, one volume: {', '.join(f'{t:.4f}' for t in times)} s",
              flush=True)

        # -- 4. the model on the card vs the same module on the CPU, f32 --------
        m32 = UNet3D(1, 2, 32, dtype=torch.float32)
        m32.load_state_dict(net.state_dict())
        m32.eval()
        c = [int(v) for v in np.argwhere(subject.gt.data[0] > 0).mean(0)]
        starts = [[min(max(c[d] - PATCH // 2 + o, 0), VOLUME[d] - PATCH) for d in range(3)] for o in (0, 16)]
        tiles = torch.from_numpy(np.stack([
            np.moveaxis(src[:, x:x + PATCH, y:y + PATCH, z:z + PATCH], 0, -1) for x, y, z in starts
        ]).astype(np.float32))
        with torch.inference_mode():
            want = m32(tiles)
            before = kernel.launches
            got = m32.to(dev)(tiles.to(dev)).cpu()
        check(kernel.launches - before == 18, "the CUDA forward did not run the kernel 18 times")
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        check(torch.isfinite(got).all().item() and got.shape == (2, PATCH, PATCH, PATCH, 2), "logits")
        check(err <= 1e-3 * scale, f"model on card vs CPU: max|diff| {err} > {1e-3 * scale}")
        check(agree >= 0.999, f"model on card vs CPU: mask agreement {agree}")
        print(f"[4] UNet3D f32 card vs CPU: max|diff| {err:.3g} (logit scale {scale:.3g}), "
              f"mask agreement {agree:.6f}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "conv3d_bn_relu",
        "route": "cuda",
        "source": f"{PORT}/csrc/conv3d_bn_relu.cu",
        "replaces": "general_medical_image_segmentation_cnn_framework_tpu/ops/pallas_conv.py:122; "
                    "general_medical_image_segmentation_cnn_framework_tpu/ops/pallas_tlayout.py:264; "
                    "general_medical_image_segmentation_cnn_framework_tpu/ops/pallas_tlayout.py:481",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": totals[torch.bfloat16][0],
        "plain_ms": totals[torch.bfloat16][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
