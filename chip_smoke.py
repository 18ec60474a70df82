#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card and ``nvcc``. It
imports nothing of JAX or of the JAX package. Without a card, or without
the repository beside it, it exits non-zero and prints no result. Phases,
each of which stops the run with a non-zero exit when it fails:

1. The card's name and power limit (``nvidia-smi``); the three CUDA sources
   of the port (``csrc/``) are built, one ``nvcc`` each, all at once, and
   the compiler's report of every kernel is printed: registers per thread,
   static shared memory, spilled bytes.
2. Conv kernel vs plain version (``conv3d_bn_relu_reference``, f32 cuDNN
   with TF32 off) at each of UNet3D's 18 conv shapes at patch 64^3, batch
   16, with random BatchNorm folded in, in bfloat16 and float32.
   Tolerances, relative to max(1, max|plain|): 1e-4 in f32 (summation order
   only); 1e-2 in bf16 against the f32 plain result from the same bf16
   inputs (one bf16 rounding of the output). Times with CUDA events.
3. The port's predict entry point (``predict.main``, config=unet,
   bfloat16, patch 64^3, overlap 4,4,36, batch 16) at full width
   (init_features=32, seeded random weights) on two synthetic 256x256x128
   volumes. The conv kernel's launch count must be 18 per forward batch.
4. The model on the card (kernel) vs the same module on the CPU (plain),
   f32, one batch of two 64^3 tiles: logits and mask agreement.
5. The fused BCE + dice kernels (sums, grads) vs their plain versions at the
   logits of both train steps, UNet3D's 16 x 64^3 x 2 and UNet2D's
   16 x 1 x 128^2 x 2 f32 ([7] and [10]), and at a ragged voxel count:
   loss sum within 1e-5 relative, the three counts exact, the gradient
   within 1e-6 * s at the train step's scale s = 1/(2V) and at s = 1 (the
   gradient is (sigmoid(l) - t) * s, so |gradient| <= s and the limit bites
   at any s: 1e-6 absolute at s = 1); three calls of each give the same
   bits. The train step's ``fused_bce_dice_metrics`` at each shape: its
   (loss, jaccard, dice) against the epilogue of the plain sums (loss within
   1e-5 relative, jaccard and dice within 1e-6 relative), and the gradient
   of its loss for a cotangent of 0.75 (the kernel divides it by 2V) within
   1e-6 * s at s = 0.75 / (2V). Per call at each shape: the device time
   (the kernel's self device time under ``torch.profiler`` over 50 calls;
   one kernel a call), the wrapper's time (CUDA events over 50 back-to-back
   calls) and the host's microseconds (the host clock around those calls).
6. The conv's input gradient (``conv3d_input_grad``: the conv kernel on
   flipped, transposed weights) vs ``torch.nn.grad.conv3d_input`` and its
   weight gradient (the wgrad kernel) vs its plain version in f64 on the
   same rounded inputs
   (so that only the kernel's own rounding is measured) at the 18 conv
   shapes, batch 16, bf16 and f32. Tolerances as
   in [2] for the input gradient; the weight gradient is f32 in both
   dtypes, so 1e-4 for both. Times: the plain version in f32 (TF32 off).
7. The port's train entry point (``train.main``, config=unet defaults:
   init_features=32, patch 64^3, batch 16, bf16, Adam, data_backend=device)
   on the volumes of [3], 3 steps per epoch for 2 epochs: every loss
   finite, ``latest_checkpoint.ckpt`` and ``checkpoint_0002.ckpt`` written,
   ``predict.main`` runs from the latest one, and every train step launched
   18 forward and 17 input-gradient conv kernels, 18 wgrad kernels, one
   sums and one grads kernel. Then warm steps of ``train.make_train_step``
   on the trained model and optimizer that ``train.main`` returns, with
   batches from the device dataset of the same config: the step's time by
   CUDA events (recorded by hooks on the model, the loss and the optimizer),
   split into forward, loss, backward and optimizer, and two more steps
   under ``torch.profiler``: the card's busy share and its time by kernel,
   with one forward and one backward loss kernel per step; then the loss
   path alone (``train.make_loss_and_metric`` forward and
   ``torch.autograd.grad`` of its loss) on the step's logits under the
   profiler: those two kernels and no other launch.
8. One train step on the card vs the same step on the CPU, f32, UNet3D at
   init_features=8 with seeded weights, batch 4 x 32^3: loss and every
   parameter's gradient.
9. The 2-D conv kernels (the KD = 1 instances: ``conv2d_bn_relu``,
   ``conv2d_input_grad``, ``conv2d_wgrad``) vs their plain versions at each
   of UNet2D's 18 conv shapes at batch 16 x 128^2, bf16 and f32, with the
   limits of [2] and [6]; times of kernel, plain version and cuDNN
   (``conv2d``, ``conv2d_input``, ``conv2d_weight``), and the bound.
10. The port's train entry point at ``config=unet2d`` defaults (UNet2D at
   its full width 64/128/256/512/512, patch 1,128,128, batch 16, bf16,
   Adam, data_backend=device) on two fresh volumes like [3]'s, 3 steps per
   epoch for 2 epochs: every loss finite, every step launched 18 forward,
   17 input-gradient and 18 weight-gradient 2-D conv kernels, one sums and
   one grads kernel, and no 3-D conv kernel. Warm steps of
   ``train.make_train_step`` (through ``models.make_forward``'s slice
   adapter) timed as in [7], with peak memory and a profile (and the loss
   path's kernels checked as in [7]); then
   ``predict.main`` from the trained checkpoint (masks, metrics.csv, 18
   ``conv2d_bn_relu`` launches per forward batch) and the sliding window on
   the card alone, in s per volume.
11. UNet2D f32, batch 4 x 32^2, card vs CPU (TF32 off): eval logits within
   1e-3 of the logit scale and masks agreeing on 99.9% of the pixels; one
   train step's loss within 1e-5 relative, the gradients within 1e-2 in
   relative L2 norm (ReLU masks flip where a pre-activation is within f32
   noise of 0, and train-mode BatchNorm spreads a flip over its channel:
   tests/test_torch_port_unet2d_f64.py), the head's within 1e-4 of its
   largest entry, the conv biases' (true gradient 0) within 1e-5.

12. The training options through ``train.main`` at ``config=unet``'s full
   width (f=32, 64^3, batch 16, bf16, data_backend=device) on fresh volumes
   like [3]'s, which also serve as the validation set, one epoch of 3
   optimizer steps each: (a) ``optimizer=adamw weight_decay=0.01
   grad_clip=1.0 grad_accum=2 ema_decay=0.99 val_interval=1`` and (b)
   ``remat=true remat_policy=conv loss=bce+dice``. Every loss finite,
   ``ema_checkpoint.ckpt`` (no optimizer state) and ``best_checkpoint.ckpt``
   (with it) written, ``predict.main`` runs from the EMA file, and the
   launches are what the code gives: under grad_accum=2 each microbatch
   launches what a step launches without it, and the validation's sliding
   window 18 eval convs a batch; under remat_policy=conv nothing launches
   twice, and bce+dice is not the fused criterion. Then warm steps (CUDA
   events) and peak memory for remat off / full / conv and grad_accum 1 /
   2, with their conv launches per step (full remat: 36 forward convs); and
   (a)'s optimizer settings with ``loss=focal`` for one step at f=8, 32^3,
   f32, card vs CPU: loss within 1e-5 relative, the clipped mean gradient
   within 1e-2 in relative L2 norm (as [11]), the conv biases' within 1e-5,
   the weights after the step within 2 lr (AdamW's first step moves each by
   about lr times the sign of its gradient) and each side's weights its own
   gradient's AdamW step (their difference within 1e-3 lr of what the two
   gradients give), the EMA within 0.02 lr.

Phases [3], [7], [10] and [12]'s train and predict runs are the main paths:
every launch counter is set to 0 just before each and read just after; a
kernel's ``launches`` in the kernel line is the sum over all of them. The kernel line's times are sums over the
convs of one train step: conv3d_bn_relu the 18 forward convs, conv3d_input_grad
the 17 input gradients, conv3d_wgrad the 18 weight gradients (bf16), at
UNet3D's shapes; conv2d_* the same at UNet2D's; the loss kernels' ``ms`` is
their device time per call at UNet3D's logits in [5] (the profiler's; up to
their redesign it was the wrapper's time, host included), with their
wrapper's time beside it as ``wrapper_ms`` and the largest error of the
three shapes of [5]. Bounds (``bound_ms``) are the larger of
the bytes the work must move (each input read once, each output written
once) over 3.35 TB/s and its FLOPs over 989 TFLOP/s (bf16 tensor cores)
or 67 TFLOP/s (f32 on CUDA cores), the H100 SXM data-sheet peaks.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PORT = "general_medical_image_segmentation_cnn_framework_tpu_torch"
JAX_SRC = "general_medical_image_segmentation_cnn_framework_tpu"
SOURCES = ("conv3d_bn_relu", "conv3d_wgrad", "fused_bce_dice")
PATCH = 64
BATCH = 16
VOLUME = (256, 256, 128)
N_VOLUMES = 2
OVERLAP = (4, 4, 36)
LEVELS = (0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 3, 3, 2, 2, 1, 1, 0, 0)  # pooling depth of ConvBlock_i
SLICE = 128  # UNet2D's patch is 1 x SLICE x SLICE (config=unet2d)
F32_TOL, BF16_TOL, WGRAD_TOL = 1e-4, 1e-2, 1e-4
TRAIN_EPOCHS, SAMPLES_PER_VOLUME = 2, 24  # 2 volumes x 24 patches = 3 batches of 16 per epoch
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
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


def profiled_ms(torch, fn, calls=50):
    """(device ms per call, {kernel: launches per call}) of the kernels ``fn``
    launches, under ``torch.profiler`` over ``calls`` calls after a warm-up:
    each kernel's mean self device time times its launches per call (the
    profiler's count over ``calls``, rounded: it may miss the first event of
    a window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    check(on_card, "the profiler recorded no device time")
    per_call = {e.key: round(e.count / calls) for e in on_card}
    return sum(per_call[e.key] * e.self_device_time_total / e.count for e in on_card) / 1e3, per_call


def wrapper_and_host(torch, fn, calls=50):
    """(ms per call by CUDA events over back-to-back calls, host us per call
    on the host's clock before the synchronisation), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, 1e6 * host / calls


def loss_kernel_times(torch, op, logits, gt, scale, calls=50):
    """{"sums" | "grads": (device ms, {kernel: launches}, wrapper ms, host us)}
    per call of ``op.bce_dice_sums(logits, gt)`` and ``op.bce_dice_grads(logits,
    gt, scale)``, by ``profiled_ms`` and ``wrapper_and_host`` (2 * (calls + 1)
    calls of each). It uses only those two public functions of the port's
    ``ops/fused_bce_dice.py``, so it times any version of it
    (``scripts/bench_torch_loss_kernels.py``)."""
    fns = {"sums": lambda: op.bce_dice_sums(logits, gt), "grads": lambda: op.bce_dice_grads(logits, gt, scale)}
    return {name: (*profiled_ms(torch, fn, calls), *wrapper_and_host(torch, fn, calls)) for name, fn in fns.items()}


def loss_path(torch, loss_fn, logits, gt):
    """One call of the train step's loss path on a copy of ``logits``:
    ``loss_fn(x, gt)[0]`` forward and ``torch.autograd.grad`` of it with a
    preallocated cotangent."""
    x = logits.clone().requires_grad_()
    one = torch.ones((), device=x.device)

    def run():
        torch.autograd.grad(loss_fn(x, gt)[0], x, one)

    return run


def loss_path_kernels(torch, loss_op, step_kernels, loss_fn, logits, gt):
    """Checks and describes the loss path's kernels: in the profile of two
    train steps (``step_kernels``, the card's events of ``key_averages``) one
    forward and one backward loss kernel per step, and in a profile of the
    loss alone (``loss_path``, on the step's own logits) those two kernels
    and nothing else."""
    def short(key):
        return key.replace("void (anonymous namespace)::", "").split("(")[0]

    in_steps = {short(e.key): e.count / 2 for e in step_kernels if "bce_dice" in e.key}
    check(len(in_steps) == 2 and all(n == 1 for n in in_steps.values()),
          f"loss kernels per step in the profile of two train steps: {in_steps}")
    counters = (loss_op.bce_dice_sums, loss_op.bce_dice_grads)
    before = [f.launches for f in counters]
    device_ms, names = profiled_ms(torch, loss_path(torch, loss_fn, logits, gt), calls=10)
    check([f.launches - b for f, b in zip(counters, before)] == [11, 11], "loss path: launch counts")
    check(len(names) == 2 and all("bce_dice" in k and n == 1 for k, n in names.items()),
          f"loss path launches {names}")
    return ("loss path: per train step " + ", ".join(f"{k} x{n:g}" for k, n in in_steps.items())
            + f"; the loss alone on the step's logits {tuple(logits.shape)} launches {sum(names.values())} "
            f"kernels per forward + backward ({', '.join(map(short, names))}), {device_ms:.5f} ms of device time")


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(flops, nbytes, dtype_name):
    """(least time in ms, what bounds it) on an H100 SXM."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def conv_work(voxels, cin, cout, itemsize, taps=27):
    """FLOPs and minimal bytes of one k3 s1 conv with ``taps`` taps (27 in
    3-D, 9 in 2-D): forward, input gradient with cin/cout swapped, or weight
    gradient, which writes f32 weights."""
    flops = 2.0 * voxels * taps * cin * cout
    return flops, voxels * (cin + cout) * itemsize + taps * cin * cout * max(itemsize, 4)


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
        elif name == "head.weight" and len(shape) == 2:  # UNet3D's nn.Linear head [Cout, Cin]
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
    from general_medical_image_segmentation_cnn_framework_tpu_torch import checkpoint, models, optim, predict, train
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict, compose
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io, make_dataset, pipeline, transforms
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.two_d.unet2d import UNet2D
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import _build as build
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu as conv
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_wgrad as wgrad_op
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import fused_bce_dice as loss_op
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import sliding_window as sw

    kernel, plain = conv.conv3d_bn_relu, conv.conv3d_bn_relu_reference
    dgrad, dgrad_plain = conv.conv3d_input_grad, conv.conv3d_input_grad_reference
    wgrad, wgrad_plain = wgrad_op.conv3d_wgrad, wgrad_op.conv3d_wgrad_reference
    sums, grads = loss_op.bce_dice_sums, loss_op.bce_dice_grads
    kernel2d, plain2d = conv.conv2d_bn_relu, conv.conv2d_bn_relu_reference
    dgrad2d, dgrad2d_plain = conv.conv2d_input_grad, conv.conv2d_input_grad_reference
    wgrad2d, wgrad2d_plain = wgrad_op.conv2d_wgrad, wgrad_op.conv2d_wgrad_reference
    counters = (kernel, dgrad, wgrad, sums, grads, kernel2d, dgrad2d, wgrad2d)
    loaded = [m for m in ("jax", "flax", JAX_SRC) if m in sys.modules]
    check(not loaded, f"the port imported {loaded}")

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
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.load, SOURCES))
    print(f"[1] built {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s", flush=True)
    # the compiler's report of every kernel: registers, static shared memory, spills
    rows = [(src, *row) for src in SOURCES for row in build.report(src)]
    demangled = [name for _, name, *_ in rows]
    if shutil.which("c++filt"):
        demangled = subprocess.run(["c++filt"], input="\n".join(demangled), capture_output=True, text=True,
                                   check=True).stdout.splitlines()
    for (src, _, regs, smem, spill_st, spill_ld), name in zip(rows, demangled):
        name = name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
        print(f"[1]   {src}: {name}: {regs} registers, {smem} bytes static shared memory, "
              f"spills {spill_st} bytes stored / {spill_ld} loaded", flush=True)

    # -- 2. kernel vs plain at the 18 UNet3D conv shapes ------------------------
    model = UNet3D(1, 2, 32, dtype=torch.bfloat16)
    widths = [tuple(block.conv.weight.shape[3:]) for block in model.blocks]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    max_err = 0.0
    totals = {torch.bfloat16: [0.0, 0.0, 0.0, 0.0], torch.float32: [0.0, 0.0, 0.0, 0.0]}
    fwd_ops = fwd_bytes = 0.0
    for i, (cin, cout) in enumerate(widths):
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
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
            k_ms = cuda_ms(torch, lambda: kernel(xd, wd, b))
            p_ms = cuda_ms(torch, lambda: plain(xd, wd, b))
            # cuDNN in the working dtype, as a library yardstick
            xc, wc = xd.permute(0, 4, 1, 2, 3), wd.permute(4, 3, 0, 1, 2).contiguous()
            c_ms = cuda_ms(torch, lambda: torch.relu(torch.nn.functional.conv3d(xc, wc, b.to(dtype), padding=1)))
            flops, nbytes = conv_work(BATCH * s**3, cin, cout, xd.element_size())
            b_ms, _ = bound_ms(flops, nbytes, str(dtype)[6:])
            if dtype == torch.bfloat16:
                fwd_ops, fwd_bytes = fwd_ops + flops, fwd_bytes + nbytes
            for j, v in enumerate((k_ms, p_ms, c_ms, b_ms)):
                totals[dtype][j] += v
            line += (f" | {str(dtype)[6:]} err {err:.3g} kernel {k_ms:.3f} ms plain {p_ms:.3f} ms "
                     f"cudnn {c_ms:.3f} ms bound {b_ms:.4f} ms")
            del got, want, xd, wd
        print(line, flush=True)
        del x
    for dtype, (k, p, c, bd) in totals.items():
        print(f"[2] sum of 18 convs, one forward batch, {str(dtype)[6:]}: kernel {k:.3f} ms, "
              f"plain {p:.3f} ms, cudnn {c:.3f} ms, bound {bd:.4f} ms", flush=True)
    launches = {f.__name__: 0 for f in counters}

    def zero_counters():
        for f in counters:
            f.launches = 0

    def read_counters():
        got = {f.__name__: f.launches for f in counters}
        for name, n in got.items():
            launches[name] += n
        return got

    # -- 3. predict through the entry point ------------------------------------
    (ROOT / "build").mkdir(exist_ok=True)
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
        zero_counters()
        t0 = time.perf_counter()
        predict.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        predict_launches = read_counters()
        check(predict_launches["conv3d_bn_relu"] == 18 * batches,
              f"kernel launches {predict_launches} != 18 x {batches} forward batches")
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
              f"launches {predict_launches}, {wall / N_VOLUMES:.3f} s per volume end to end; "
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
        del net, vol

        # -- 4. the model on the card vs the same module on the CPU, f32 --------
        m32 = UNet3D(1, 2, 32, dtype=torch.float32)
        m32.load_state_dict(checkpoint.load_checkpoint(ckpt)["params"])
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
        del m32

        # -- 5. fused BCE + dice kernels vs plain -----------------------------------
        loss_rows, loss_errs = {}, {"sums": 0.0, "grads": 0.0}
        # UNet3D's logits, UNet2D's ([10] gives the kernels [BATCH, 1, SLICE, SLICE, 2]) and a ragged count
        for shape in ((BATCH, PATCH, PATCH, PATCH), (BATCH, 1, SLICE, SLICE), (3, 17, 19, 23)):
            voxels = math.prod(shape)
            logits = 3.0 * randn(*shape, 2)
            gt = (torch.rand(*shape, 1, device=dev, generator=gen) > 0.7).float()
            got, want = sums(logits, gt), loss_op.bce_dice_sums_reference(logits, gt)
            torch.cuda.synchronize()
            loss_err = abs(got[0].item() - want[0].item())
            check(loss_err <= 1e-5 * abs(want[0].item()), f"bce_dice_sums {shape}: loss sum error {loss_err}")
            check(got[1:].tolist() == want[1:].tolist(), f"bce_dice_sums {shape}: counts {got[1:]} != {want[1:]}")
            grad_errs = []
            for s_val in (0.5 / voxels, 1.0):  # the train step's scale, and 1
                scale_t = torch.full((1,), s_val, device=dev)
                d_got, d_want = grads(logits, gt, scale_t), loss_op.bce_dice_grads_reference(logits, gt, scale_t)
                torch.cuda.synchronize()
                grad_errs.append((d_got - d_want).abs().max().item())
                check(d_want.abs().max().item() >= 0.5 * s_val, f"bce_dice_grads {shape}: gradient scale")
                check(grad_errs[-1] <= 1e-6 * s_val,
                      f"bce_dice_grads {shape} s={s_val:.3g}: max abs error {grad_errs[-1]} > {1e-6 * s_val}")
            grad_err = grad_errs[-1]  # at s = 1: in units of the gradient's scale
            # the train step's function: (loss, jaccard, dice) from the forward kernel's epilogue, and the
            # gradient from the backward kernel at s = ct / (2V), with ct != 1 so that its division is checked
            x, ct = logits.clone().requires_grad_(), torch.full((), 0.75, device=dev)
            metrics = loss_op.fused_bce_dice_metrics(x, gt)
            (d_got,) = torch.autograd.grad(metrics[0], x, ct)
            m_want = loss_op._metrics_reference(loss_op.bce_dice_sums_reference(logits, gt), voxels, 0.001)
            s_ct = (ct / (2.0 * voxels)).reshape(1)
            d_want = loss_op.bce_dice_grads_reference(logits, gt, s_ct)
            torch.cuda.synchronize()
            m_errs = [abs(a.item() - b.item()) / abs(b.item()) if b.item() else abs(a.item())
                      for a, b in zip(metrics, m_want)]
            check(m_errs[0] <= 1e-5 and max(m_errs[1:]) <= 1e-6,
                  f"fused_bce_dice_metrics {shape}: (loss, jaccard, dice) relative errors {m_errs}")
            fused_err = (d_got - d_want).abs().max().item()
            check(fused_err <= 1e-6 * s_ct.item(),
                  f"fused_bce_dice_metrics {shape}: gradient error {fused_err} > {1e-6 * s_ct.item()}")
            scale_t = torch.full((1,), 0.5 / voxels, device=dev)
            runs = [(sums(logits, gt), grads(logits, gt, scale_t)) for _ in range(3)]
            check(all(torch.equal(a, runs[0][0]) and torch.equal(b, runs[0][1]) for a, b in runs[1:]),
                  f"bce_dice {shape}: three calls differ")
            before = (sums.launches, grads.launches)
            times = loss_kernel_times(torch, loss_op, logits, gt, scale_t)
            check((sums.launches - before[0], grads.launches - before[1]) == (102, 102)
                  and all(list(t[1].values()) == [1] for t in times.values()),
                  f"bce_dice {shape}: kernels per call {[t[1] for t in times.values()]}")
            row = {}
            for name, plain_fn, cost in (
                ("sums", lambda: loss_op.bce_dice_sums_reference(logits, gt), (20.0 * voxels, 12.0 * voxels + 28)),
                ("grads", lambda: loss_op.bce_dice_grads_reference(logits, gt, scale_t),
                 (10.0 * voxels, 20.0 * voxels + 4)),
            ):
                device_ms, _, wrapper_ms, host_us = times[name]
                row[name] = (device_ms, cuda_ms(torch, plain_fn), *bound_ms(*cost, "float32"), wrapper_ms, host_us)
            target = torch.cat([1.0 - gt, gt], dim=-1)
            bce_ms = cuda_ms(torch, lambda: torch.nn.functional.binary_cross_entropy_with_logits(logits, target))
            loss_errs = {"sums": max(loss_errs["sums"], loss_err), "grads": max(loss_errs["grads"], grad_err)}
            if shape == (BATCH, PATCH, PATCH, PATCH):  # the kernel line gives the 3-D shape
                loss_rows = row
            print(f"[5] {shape} x 2 f32 logits: sums err {loss_err:.3g}, grads err {grad_errs[0]:.3g} at s=1/(2V), "
                  f"{grad_errs[1]:.3g} at s=1; fused_bce_dice_metrics (loss, jaccard, dice) relative errors "
                  f"{', '.join(f'{e:.3g}' for e in m_errs)}, gradient err {fused_err:.3g} at s=0.75/(2V); "
                  f"three calls bit-identical; "
                  + "; ".join(f"{k} device {r[0]:.5f} ms (bound {r[2]:.5f}, plain {r[1]:.4f}), wrapper {r[4]:.5f} ms, "
                              f"host {r[5]:.1f} us per call" for k, r in row.items())
                  + f" | F.binary_cross_entropy_with_logits (the loss alone, for scale) {bce_ms:.4f} ms", flush=True)
            del logits, gt, target, d_got, d_want, runs, x, metrics

        # -- 6. input and weight gradients at the 18 conv shapes ------------------
        bw = {dt: {"dgrad": [0.0] * 4, "wgrad": [0.0] * 4} for dt in ("bfloat16", "float32")}
        wgrad_err = dgrad_err = 0.0
        wgrad_ops = wgrad_bytes = dgrad_ops = dgrad_bytes = 0.0
        for i, (cin, cout) in enumerate(widths):
            s = PATCH >> LEVELS[i]
            x, g = randn(BATCH, s, s, s, cin), randn(BATCH, s, s, s, cout)
            w = randn(3, 3, 3, cin, cout) * (27 * cin) ** -0.5
            line = f"[6] ConvBlock_{i:<2d} {cin:>3d}->{cout:<3d} {BATCH}x{s}^3"
            for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
                name = str(dtype)[6:]
                xd, gd, wd = x.to(dtype), g.to(dtype), w.to(dtype)
                flops, nbytes = conv_work(BATCH * s**3, cin, cout, xd.element_size())
                if i > 0:  # the stem's input is data: its input gradient is never taken
                    dx = dgrad(gd, wd)
                    torch.cuda.synchronize()
                    want = torch.nn.grad.conv3d_input(
                        (BATCH, cin, s, s, s), wd.float().permute(4, 3, 0, 1, 2), gd.float().permute(0, 4, 1, 2, 3),
                        padding=1,
                    ).permute(0, 2, 3, 4, 1)
                    err = (dx.float() - want).abs().max().item()
                    check(err <= tol * max(1.0, want.abs().max().item()), f"dgrad ConvBlock_{i} {name}: error {err}")
                    wc, gc = wd.permute(4, 3, 0, 1, 2).contiguous(), gd.permute(0, 4, 1, 2, 3)
                    t = (cuda_ms(torch, lambda: dgrad(gd, wd)),
                         cuda_ms(torch, lambda: dgrad_plain(gd, wd)),
                         cuda_ms(torch, lambda: torch.nn.grad.conv3d_input((BATCH, cin, s, s, s), wc, gc, padding=1)),
                         bound_ms(flops, nbytes, name)[0])
                    for j, v in enumerate(t):
                        bw[name]["dgrad"][j] += v
                    if dtype == torch.bfloat16:
                        dgrad_err = max(dgrad_err, err)
                        dgrad_ops, dgrad_bytes = dgrad_ops + flops, dgrad_bytes + nbytes
                    line += f" | {name} dgrad err {err:.3g} kernel {t[0]:.3f} plain {t[1]:.3f} cudnn {t[2]:.3f} bound {t[3]:.4f}"
                    del dx, want
                dw = wgrad(xd, gd)
                torch.cuda.synchronize()
                want = wgrad_plain(xd.double(), gd.double())  # f64: exact on the same rounded inputs
                err = (dw.double() - want).abs().max().item()
                check(dw.dtype == torch.float32 and dw.shape == want.shape, f"wgrad ConvBlock_{i} {name}: dtype/shape")
                check(err <= WGRAD_TOL * max(1.0, want.abs().max().item()), f"wgrad ConvBlock_{i} {name}: error {err}")
                xc, gc = xd.permute(0, 4, 1, 2, 3), gd.permute(0, 4, 1, 2, 3)
                t = (cuda_ms(torch, lambda: wgrad(xd, gd)),
                     cuda_ms(torch, lambda: wgrad_plain(xd, gd)),
                     cuda_ms(torch, lambda: torch.nn.grad.conv3d_weight(xc, (cout, cin, 3, 3, 3), gc, padding=1)),
                     bound_ms(flops, nbytes, name)[0])
                for j, v in enumerate(t):
                    bw[name]["wgrad"][j] += v
                if dtype == torch.bfloat16:
                    wgrad_err = max(wgrad_err, err)
                    wgrad_ops, wgrad_bytes = wgrad_ops + flops, wgrad_bytes + nbytes
                line += f" | {name} wgrad err {err:.3g} kernel {t[0]:.3f} plain {t[1]:.3f} cudnn {t[2]:.3f} bound {t[3]:.4f}"
                del dw, want, xd, gd, wd
            print(line + " (ms)", flush=True)
            del x, g, w
        for name, parts in bw.items():
            fwd = totals[getattr(torch, name)]
            print(f"[6] sums per train step, {name}: forward (18) kernel {fwd[0]:.3f} ms, "
                  + ", ".join(f"{k} ({17 if k == 'dgrad' else 18}) kernel {v[0]:.3f} ms plain {v[1]:.3f} ms "
                              f"cudnn {v[2]:.3f} ms bound {v[3]:.4f} ms" for k, v in parts.items())
                  + f"; all conv kernels {fwd[0] + parts['dgrad'][0] + parts['wgrad'][0]:.3f} ms", flush=True)

        # -- 7. train through the entry point ------------------------------------
        steps = TRAIN_EPOCHS * (N_VOLUMES * SAMPLES_PER_VOLUME // BATCH)
        train_argv = [
            "config=unet",
            f"config.data_path={work / 'data' / 'source'}",
            f"config.gt_path={work / 'data' / 'label'}",
            f"config.output_dir={work / 'train_runs'}",
            f"config.patch_size={PATCH}, {PATCH}, {PATCH}",
            f"config.batch_size={BATCH}",
            f"config.samples_per_volume={SAMPLES_PER_VOLUME}",
            f"config.epochs={TRAIN_EPOCHS}",
            f"config.epochs_per_checkpoint={TRAIN_EPOCHS}",
        ]
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        out = train.main(train_argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train_launches = read_counters()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        want_launches = {"conv3d_bn_relu": 18 * steps, "conv3d_input_grad": 17 * steps,
                         "conv3d_wgrad": 18 * steps, "bce_dice_sums": steps, "bce_dice_grads": steps,
                         "conv2d_bn_relu": 0, "conv2d_input_grad": 0, "conv2d_wgrad": 0}
        check(train_launches == want_launches, f"train launches {train_launches} != {want_launches}")
        (run,) = (work / "train_runs").glob("train-*/*")
        losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
                  if line.startswith("Loss: ")]
        check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"train losses {losses}")
        latest = checkpoint.load_checkpoint(run / "latest_checkpoint.ckpt")
        check(latest["epoch"] == TRAIN_EPOCHS and latest["optimizer"] == "adam" and latest["opt_state"]["state"],
              "latest_checkpoint.ckpt")
        check((run / f"checkpoint_{TRAIN_EPOCHS:04d}.ckpt").exists(), "periodic checkpoint")
        print(f"[7] train.main: {steps} steps in {wall:.1f} s (build and data included), launches "
              f"{train_launches}, losses {[round(v, 5) for v in losses]}, dice of the last epoch "
              f"{out['dice']:.4f}, peak memory {peak_gb:.2f} GiB", flush=True)

        one = work / "one"
        for split in ("source", "label"):
            (one / split).mkdir(parents=True)
            os.symlink(work / "data" / split / "vol-00.nii.gz", one / split / "vol-00.nii.gz")
        zero_counters()
        predict.main(argv[:1] + [f"config.pred_data_path={one / 'source'}", f"config.pred_gt_path={one / 'label'}",
                                 f"config.output_dir={work / 'runs_trained'}",
                                 f"config.ckpt={run / 'latest_checkpoint.ckpt'}"] + argv[5:])
        after = read_counters()
        check(after["conv3d_bn_relu"] == 18 * -(-n_tiles // BATCH), f"predict after train: launches {after}")
        (pred_run,) = (work / "runs_trained").glob("predict-*/*")
        print(f"[7] predict.main from the trained checkpoint: "
              f"{(pred_run / 'metrics.csv').read_text().splitlines()[1]}", flush=True)

        # warm steps of the entry point's train step on the device dataset's
        # batches; CUDA events recorded by hooks split each step
        cfg = compose(train_argv, job_name="train", make_run_dir=False)
        net, opt = out["model"], out["optimizer"]
        dataset = make_dataset(cfg, is_train=True, device=dev)
        reps = 5
        step_batches = []
        while len(step_batches) < reps + 2:
            step_batches.extend(dataset)
        marks = []

        def mark(*_):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

        loss_fn = train.make_loss_and_metric(cfg)
        seen = []  # the logits and mask of the last step's loss

        def marked_loss(pred, gt):
            result = loss_fn(pred, gt)
            mark()
            seen[:] = [pred.detach(), gt]
            return result

        hooks = [net.register_forward_pre_hook(mark), net.register_forward_hook(mark),
                 opt.register_step_pre_hook(mark), opt.register_step_post_hook(mark)]
        step = train.make_train_step(net, opt, marked_loss)
        split = np.zeros(4)
        for rep, (xb, yb) in enumerate(step_batches[:reps + 2]):
            marks.clear()
            step(xb, yb)
            check(len(marks) == 5, f"train step hooks fired {len(marks)} times, not 5")
            marks[-1].synchronize()
            if rep >= 2:  # two warm-up steps
                split += [marks[k].elapsed_time(marks[k + 1]) for k in range(4)]
        for h in hooks:
            h.remove()
        split /= reps
        step_ms = split.sum()
        print(f"[7] warm train step (bf16, f=32, {BATCH}x{PATCH}^3): {step_ms:.3f} ms, "
              f"{1e3 * BATCH / step_ms:.1f} samples/s; forward {split[0]:.3f} ms, loss {split[1]:.3f} ms, "
              f"backward {split[2]:.3f} ms, optimizer {split[3]:.3f} ms", flush=True)

        # two more warm steps under torch.profiler: the card's time by kernel
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for xb, yb in step_batches[:2]:
                step(xb, yb)
            torch.cuda.synchronize()
            window_ms = 1e3 * (time.perf_counter() - t0)
        on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
        if not on_card:
            print("[7] profile: the profiler recorded no device time (not measured)", flush=True)
        else:
            print(f"[7] profile of 2 warm steps: the card busy {busy_ms:.1f} of {window_ms:.1f} ms "
                  f"({100 * busy_ms / window_ms:.1f}%); per step, the 15 largest kernels:", flush=True)
            for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:15]:
                print(f"[7]   {e.self_device_time_total / 2e3:8.3f} ms  x{e.count // 2:<4d} {e.key[:100]}", flush=True)
        print(f"[7] {loss_path_kernels(torch, loss_op, on_card, loss_fn, *seen)}", flush=True)
        del net, opt, out, dataset, step_batches, xb, yb, step, seen
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- 8. one train step on the card vs the CPU, f32 ---------------------------
    cfg = ConfigDict(out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3)
    rng = np.random.default_rng(SEED + 8)
    xs = torch.from_numpy(rng.normal(size=(4, 32, 32, 32, 1)).astype(np.float32))
    ys = torch.from_numpy((rng.uniform(size=(4, 32, 32, 32, 1)) > 0.7).astype(np.float32))
    sd = random_state_dict(torch, UNet3D(1, 2, 8), SEED + 8)
    results = []
    for device in (torch.device("cpu"), dev):
        net = UNet3D(1, 2, 8)
        net.load_state_dict(sd)
        net.to(device).train()
        loss, _ = train.make_loss_and_metric(cfg)(net(xs.to(device)), ys.to(device))
        loss.backward()
        results.append((loss.item(), {n: p.grad.detach().cpu() for n, p in net.named_parameters()}))
    (cpu_loss, cpu_grads), (gpu_loss, gpu_grads) = results
    check(abs(gpu_loss - cpu_loss) <= 1e-5 * cpu_loss, f"train step loss card {gpu_loss} vs CPU {cpu_loss}")
    worst = bias_worst = 0.0
    for name, want in cpu_grads.items():
        diff = (gpu_grads[name] - want).abs().max().item()
        if name.endswith("conv.bias"):  # true gradient 0: BatchNorm removes the shift
            bias_worst = max(bias_worst, diff)
        else:
            worst = max(worst, diff / want.abs().max().item())
    check(worst <= 2e-3, f"train step gradients card vs CPU: worst relative error {worst}")
    check(bias_worst <= 1e-5, f"train step conv-bias gradients card vs CPU: {bias_worst}")
    print(f"[8] UNet3D f=8 train step f32, card vs CPU: loss {gpu_loss:.6f} vs {cpu_loss:.6f}, worst gradient "
          f"error {worst:.3g} of the tensor's largest, conv biases (true gradient 0) {bias_worst:.3g}", flush=True)

    # -- 9. the 2-D conv kernels (KD = 1) at the 18 UNet2D conv shapes ----------
    widths2d = [tuple(block.conv.weight.shape[2:]) for block in UNet2D(1, 2).blocks]
    t2d = {dt: {k: [0.0] * 4 for k in ("fwd", "dgrad", "wgrad")} for dt in ("bfloat16", "float32")}
    err2d = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    work2d = {k: [0.0, 0.0] for k in ("fwd", "dgrad", "wgrad")}  # bf16 FLOPs and bytes, summed
    f_conv2d_input, f_conv2d_weight = torch.nn.grad.conv2d_input, torch.nn.grad.conv2d_weight
    for i, (cin, cout) in enumerate(widths2d):
        s = SLICE >> LEVELS[i]
        x, g = randn(BATCH, s, s, cin), randn(BATCH, s, s, cout)
        w, b = conv.fold_batchnorm(
            randn(3, 3, cin, cout) * (9 * cin) ** -0.5, 0.1 * randn(cout),
            0.5 + torch.rand(cout, device=dev, generator=gen), 0.1 * randn(cout),
            0.1 * randn(cout), 0.5 + 1.5 * torch.rand(cout, device=dev, generator=gen),
        )
        line = f"[9] ConvBlock_{i:<2d} {cin:>4d}->{cout:<3d} {BATCH}x{s}^2"
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            name = str(dtype)[6:]
            xd, gd, wd = x.to(dtype), g.to(dtype), w.to(dtype)
            xc, gc, wc = xd.permute(0, 3, 1, 2), gd.permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1).contiguous()
            flops, nbytes = conv_work(BATCH * s * s, cin, cout, xd.element_size(), taps=9)
            b_ms = bound_ms(flops, nbytes, name)[0]
            y = kernel2d(xd, wd, b)
            torch.cuda.synchronize()
            want = plain2d(xd.float(), wd.float(), b)
            err, lim = (y.float() - want).abs().max().item(), tol * max(1.0, want.abs().max().item())
            check(y.dtype == dtype and y.shape == want.shape, f"conv2d ConvBlock_{i} {name}: dtype/shape")
            check(err <= lim, f"conv2d ConvBlock_{i} {name}: error {err} > {lim}")
            del y, want
            t = (cuda_ms(torch, lambda: kernel2d(xd, wd, b)), cuda_ms(torch, lambda: plain2d(xd, wd, b)),
                 cuda_ms(torch, lambda: torch.relu(torch.nn.functional.conv2d(xc, wc, b.to(dtype), padding=1))), b_ms)
            parts = [("fwd", err, lim, t)]
            if i > 0:  # the stem's input is data: its input gradient is never taken
                dx = dgrad2d(gd, wd)
                torch.cuda.synchronize()
                want = f_conv2d_input((BATCH, cin, s, s), wd.float().permute(3, 2, 0, 1), gd.float().permute(0, 3, 1, 2),
                                      padding=1).permute(0, 2, 3, 1)
                err, lim = (dx.float() - want).abs().max().item(), tol * max(1.0, want.abs().max().item())
                check(dx.dtype == dtype and dx.shape == want.shape, f"dgrad2d ConvBlock_{i} {name}: dtype/shape")
                check(err <= lim, f"dgrad2d ConvBlock_{i} {name}: error {err} > {lim}")
                del dx, want
                t = (cuda_ms(torch, lambda: dgrad2d(gd, wd)), cuda_ms(torch, lambda: dgrad2d_plain(gd, wd)),
                     cuda_ms(torch, lambda: f_conv2d_input((BATCH, cin, s, s), wc, gc, padding=1)), b_ms)
                parts.append(("dgrad", err, lim, t))
            dw = wgrad2d(xd, gd)
            torch.cuda.synchronize()
            want = wgrad2d_plain(xd.double(), gd.double())  # f64: exact on the same rounded inputs
            err, lim = (dw.double() - want).abs().max().item(), WGRAD_TOL * max(1.0, want.abs().max().item())
            check(dw.dtype == torch.float32 and dw.shape == want.shape, f"wgrad2d ConvBlock_{i} {name}: dtype/shape")
            check(err <= lim, f"wgrad2d ConvBlock_{i} {name}: error {err} > {lim}")
            del dw, want
            t = (cuda_ms(torch, lambda: wgrad2d(xd, gd)), cuda_ms(torch, lambda: wgrad2d_plain(xd, gd)),
                 cuda_ms(torch, lambda: f_conv2d_weight(xc, (cout, cin, 3, 3), gc, padding=1)), b_ms)
            parts.append(("wgrad", err, lim, t))
            for key, e, lim, t in parts:
                for j, v in enumerate(t):
                    t2d[name][key][j] += v
                if dtype == torch.bfloat16:
                    err2d[key] = max(err2d[key], e)
                    work2d[key][0] += flops
                    work2d[key][1] += nbytes
                line += (f" | {name} {key} err {e:.3g} (limit {lim:.3g}) kernel {t[0]:.3f} plain {t[1]:.3f} "
                         f"cudnn {t[2]:.3f} bound {t[3]:.4f}")
            del xd, gd, wd, xc, gc, wc
        print(line + " (ms)", flush=True)
        del x, g, w, b
    for name, parts in t2d.items():
        print(f"[9] sums per UNet2D train step, {name}: "
              + ", ".join(f"{k} ({17 if k == 'dgrad' else 18}) kernel {v[0]:.3f} ms plain {v[1]:.3f} ms "
                          f"cudnn {v[2]:.3f} ms bound {v[3]:.4f} ms" for k, v in parts.items())
              + f"; all conv kernels {sum(v[0] for v in parts.values()):.3f} ms", flush=True)

    # -- 10. train and predict UNet2D through the entry points ---------------
    work = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build"))
    try:
        write_volumes(work / "data", io)
        steps = TRAIN_EPOCHS * (N_VOLUMES * SAMPLES_PER_VOLUME // BATCH)
        patch2d = f"1, {SLICE}, {SLICE}"
        train_argv = [
            "config=unet2d",
            f"config.data_path={work / 'data' / 'source'}",
            f"config.gt_path={work / 'data' / 'label'}",
            f"config.output_dir={work / 'train_runs'}",
            f"config.batch_size={BATCH}",
            f"config.samples_per_volume={SAMPLES_PER_VOLUME}",
            f"config.epochs={TRAIN_EPOCHS}",
            f"config.epochs_per_checkpoint={TRAIN_EPOCHS}",
        ]
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        out = train.main(train_argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train_launches = read_counters()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        want_launches = {"conv3d_bn_relu": 0, "conv3d_input_grad": 0, "conv3d_wgrad": 0,
                         "bce_dice_sums": steps, "bce_dice_grads": steps, "conv2d_bn_relu": 18 * steps,
                         "conv2d_input_grad": 17 * steps, "conv2d_wgrad": 18 * steps}
        check(train_launches == want_launches, f"unet2d train launches {train_launches} != {want_launches}")
        check(isinstance(out["model"], UNet2D), f"config=unet2d trained a {type(out['model']).__name__}")
        n_params = sum(p.numel() for p in out["model"].parameters())
        (run,) = (work / "train_runs").glob("train-*/*")
        losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
                  if line.startswith("Loss: ")]
        check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"unet2d train losses {losses}")
        latest = checkpoint.load_checkpoint(run / "latest_checkpoint.ckpt")
        check(latest["epoch"] == TRAIN_EPOCHS and latest["opt_state"]["state"], "unet2d latest_checkpoint.ckpt")
        check((run / f"checkpoint_{TRAIN_EPOCHS:04d}.ckpt").exists(), "unet2d periodic checkpoint")
        print(f"[10] train.main config=unet2d ({n_params:,} parameters, patch {patch2d}, batch {BATCH}, bf16): "
              f"{steps} steps in {wall:.1f} s (data included), launches {train_launches}, losses "
              f"{[round(v, 5) for v in losses]}, dice of the last epoch {out['dice']:.4f}, peak memory "
              f"{peak_gb:.2f} GiB", flush=True)

        # warm steps through the entry point's train step and slice adapter, as in [7]
        cfg = compose(train_argv, job_name="train", make_run_dir=False)
        net, opt = out["model"], out["optimizer"]
        dataset = make_dataset(cfg, is_train=True, device=dev)
        reps = 5
        step_batches = []
        while len(step_batches) < reps + 2:
            step_batches.extend(dataset)
        check(tuple(step_batches[0][0].shape) == (BATCH, 1, SLICE, SLICE, 1), f"batch {step_batches[0][0].shape}")
        marks = []

        def mark(*_):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

        loss_fn = train.make_loss_and_metric(cfg)
        seen = []  # the logits and mask of the last step's loss

        def marked_loss(pred, gt):
            result = loss_fn(pred, gt)
            mark()
            seen[:] = [pred.detach(), gt]
            return result

        hooks = [net.register_forward_pre_hook(mark), net.register_forward_hook(mark),
                 opt.register_step_pre_hook(mark), opt.register_step_post_hook(mark)]
        step = train.make_train_step(models.make_forward(cfg, net), opt, marked_loss)
        split = np.zeros(4)
        for rep, (xb, yb) in enumerate(step_batches[:reps + 2]):
            marks.clear()
            step(xb, yb)
            check(len(marks) == 5, f"unet2d train step hooks fired {len(marks)} times, not 5")
            marks[-1].synchronize()
            if rep >= 2:  # two warm-up steps
                split += [marks[k].elapsed_time(marks[k + 1]) for k in range(4)]
        for h in hooks:
            h.remove()
        split /= reps
        step_ms = split.sum()
        print(f"[10] warm train step (UNet2D bf16, {BATCH}x{SLICE}^2): {step_ms:.3f} ms, "
              f"{1e3 * BATCH / step_ms:.1f} samples/s; forward {split[0]:.3f} ms, loss {split[1]:.3f} ms, "
              f"backward {split[2]:.3f} ms, optimizer {split[3]:.3f} ms", flush=True)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for xb, yb in step_batches[:2]:
                step(xb, yb)
            torch.cuda.synchronize()
            window_ms = 1e3 * (time.perf_counter() - t0)
        on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
        if not on_card:
            print("[10] profile: the profiler recorded no device time (not measured)", flush=True)
        else:
            print(f"[10] profile of 2 warm steps: the card busy {busy_ms:.1f} of {window_ms:.1f} ms "
                  f"({100 * busy_ms / window_ms:.1f}%); per step {sum(e.count for e in on_card) / 2:.0f} kernel "
                  f"launches and {busy_ms / 2:.3f} ms of device time against the {step_ms:.3f} ms step timed "
                  f"without the profiler ({50 * busy_ms / step_ms:.1f}%); the 15 largest kernels:", flush=True)
            for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:15]:
                print(f"[10]   {e.self_device_time_total / 2e3:8.3f} ms  x{e.count // 2:<4d} {e.key[:100]}", flush=True)
        print(f"[10] {loss_path_kernels(torch, loss_op, on_card, loss_fn, *seen)}", flush=True)
        del opt, out, dataset, step_batches, xb, yb, step, seen

        one = work / "one"
        for split_dir in ("source", "label"):
            (one / split_dir).mkdir(parents=True)
            os.symlink(work / "data" / split_dir / "vol-00.nii.gz", one / split_dir / "vol-00.nii.gz")
        n_tiles = len(pipeline.grid_locations(VOLUME, (1, SLICE, SLICE), (0, 4, 36)))
        zero_counters()
        t0 = time.perf_counter()
        predict.main([
            "config=unet2d", f"config.pred_data_path={one / 'source'}", f"config.pred_gt_path={one / 'label'}",
            f"config.output_dir={work / 'runs'}", f"config.ckpt={run / 'latest_checkpoint.ckpt'}",
            f"config.batch_size={BATCH}",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        predict_launches = read_counters()
        batches = -(-n_tiles // BATCH)
        check(predict_launches["conv2d_bn_relu"] == 18 * batches and predict_launches["conv3d_bn_relu"] == 0,
              f"unet2d predict launches {predict_launches} != 18 x {batches} forward batches")
        (pred_run,) = (work / "runs").glob("predict-*/*")
        rows = (pred_run / "metrics.csv").read_text().splitlines()
        check(rows[0] == "precision,recall,jaccard,dice,hs95" and len(rows) == 3, f"unet2d metrics.csv: {rows}")
        check(all(0.0 <= float(v) <= 1.0 for v in rows[1].split(",")[:4]), f"unet2d metrics row: {rows[1]}")
        (mask_file,) = (pred_run / "pred_file").glob("pred-*.nii.gz")
        mask = io.read_volume(mask_file).data
        check(mask.shape == (1, *VOLUME) and set(np.unique(mask).tolist()) <= {0.0, 1.0}, f"unet2d mask {mask.shape}")
        print(f"[10] predict.main config=unet2d from the trained checkpoint: {n_tiles} slices of 1x{SLICE}x{SLICE}, "
              f"{batches} forward batches, launches {predict_launches}, {wall:.3f} s end to end; metrics {rows[1]}",
              flush=True)

        # the device part alone: the sliding window over the uploaded volume, warm
        net.eval()
        subject = pipeline.load_subject((one / "source" / "vol-00.nii.gz", one / "label" / "vol-00.nii.gz"))
        vol = sw.prepare_volume(transforms.ZNormalization().normalize_array(subject.source.data), dev, net.dtype)
        fwd2d = models.make_forward(cfg, net)
        sw.sliding_window_predict(fwd2d, vol, (1, SLICE, SLICE), (0, 4, 36), BATCH)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sw.sliding_window_predict(fwd2d, vol, (1, SLICE, SLICE), (0, 4, 36), BATCH)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"[10] UNet2D sliding window on the card, one volume: {', '.join(f'{t:.4f}' for t in times)} s",
              flush=True)
        del net, vol, fwd2d
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- 11. UNet2D on the card vs the CPU, f32: eval logits and a train step --
    cfg2d = ConfigDict(network="unet2d", out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3)
    rng = np.random.default_rng(SEED + 11)
    xs = torch.from_numpy(rng.normal(size=(4, 1, 32, 32, 1)).astype(np.float32))
    ys = torch.from_numpy((rng.uniform(size=(4, 1, 32, 32, 1)) > 0.7).astype(np.float32))
    sd = random_state_dict(torch, UNet2D(1, 2), SEED + 11)
    results = []
    for device in (torch.device("cpu"), dev):
        net = UNet2D(1, 2)
        net.load_state_dict(sd)
        net.to(device).eval()
        with torch.inference_mode():
            logits = net(xs[:, 0].to(device)).cpu()
        net.train()
        loss, _ = train.make_loss_and_metric(cfg2d)(models.make_forward(cfg2d, net)(xs.to(device)), ys.to(device))
        loss.backward()
        results.append((logits, loss.item(), {n: p.grad.detach().double().cpu() for n, p in net.named_parameters()}))
    (cpu_logits, cpu_loss, cpu_grads), (gpu_logits, gpu_loss, gpu_grads) = results
    scale = max(1.0, cpu_logits.abs().max().item())
    err = (gpu_logits - cpu_logits).abs().max().item()
    agree = (gpu_logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean().item()
    check(gpu_logits.shape == (4, 32, 32, 2) and torch.isfinite(gpu_logits).all().item(), "unet2d logits")
    check(err <= 1e-3 * scale, f"UNet2D eval card vs CPU: max|diff| {err} > {1e-3 * scale}")
    check(agree >= 0.999, f"UNet2D eval card vs CPU: mask agreement {agree}")
    check(abs(gpu_loss - cpu_loss) <= 1e-5 * cpu_loss, f"UNet2D train step loss card {gpu_loss} vs CPU {cpu_loss}")
    # the gradient is piecewise (ReLU masks flip where a pre-activation is within f32 noise of 0, and
    # train-mode BatchNorm spreads a flip over its channel): held in relative L2 norm, as in
    # tests/test_torch_port_unet2d.py; the head, above every ReLU, to 1e-4 of its largest entry
    worst = head_worst = bias_worst = 0.0
    for name, want in cpu_grads.items():
        got = gpu_grads[name]
        if name.endswith("conv.bias"):  # true gradient 0: BatchNorm removes the shift
            bias_worst = max(bias_worst, (got - want).abs().max().item())
        elif name.startswith("head"):
            head_worst = max(head_worst, (got - want).abs().max().item() / want.abs().max().item())
        else:
            worst = max(worst, ((got - want).norm() / want.norm()).item())
    check(worst <= 1e-2, f"UNet2D train step gradients card vs CPU: worst relative L2 error {worst}")
    check(head_worst <= 1e-4, f"UNet2D train step head gradient card vs CPU: {head_worst}")
    check(bias_worst <= 1e-5, f"UNet2D train step conv-bias gradients card vs CPU: {bias_worst}")
    print(f"[11] UNet2D f32 card vs CPU: eval max|diff| {err:.3g} (logit scale {scale:.3g}), mask agreement "
          f"{agree:.6f}; train step loss {gpu_loss:.6f} vs {cpu_loss:.6f}, worst gradient error {worst:.3g} "
          f"(relative L2), head {head_worst:.3g}, conv biases (true gradient 0) {bias_worst:.3g}", flush=True)

    # -- 12. the training options through train.main, and their cost ---------
    work = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build"))
    try:
        write_volumes(work / "data", io)
        steps = N_VOLUMES * SAMPLES_PER_VOLUME // BATCH  # one epoch
        n_tiles = len(pipeline.grid_locations(VOLUME, (PATCH,) * 3, OVERLAP))
        val_batches = N_VOLUMES * -(-n_tiles // BATCH)
        base = [
            "config=unet",
            f"config.data_path={work / 'data' / 'source'}",
            f"config.gt_path={work / 'data' / 'label'}",
            f"config.val_data_path={work / 'data' / 'source'}",
            f"config.val_gt_path={work / 'data' / 'label'}",
            f"config.patch_size={PATCH}, {PATCH}, {PATCH}",
            "config.patch_overlap=" + ", ".join(map(str, OVERLAP)),
            f"config.batch_size={BATCH}",
            f"config.samples_per_volume={SAMPLES_PER_VOLUME}",
            "config.epochs=1",
            "config.epochs_per_checkpoint=1",
        ]
        options = {
            "a": ["config.optimizer=adamw", "config.weight_decay=0.01", "config.grad_clip=1.0", "config.grad_accum=2",
                  "config.ema_decay=0.99", "config.val_interval=1"],
            "b": ["config.remat=true", "config.remat_policy=conv", "config.loss=bce+dice"],
        }
        none2d = {"conv2d_bn_relu": 0, "conv2d_input_grad": 0, "conv2d_wgrad": 0}
        # (a): each optimizer step is two microbatches, each launching what a step launches
        # without grad_accum; the validation's sliding window runs 18 eval convs a batch.
        # (b): remat_policy=conv recomputes BatchNorm and ReLU only, so no conv runs twice;
        # bce+dice is not the fused criterion, so no loss kernel runs
        want = {
            "a": {"conv3d_bn_relu": 2 * 18 * steps + 18 * val_batches, "conv3d_input_grad": 2 * 17 * steps,
                  "conv3d_wgrad": 2 * 18 * steps, "bce_dice_sums": 2 * steps, "bce_dice_grads": 2 * steps, **none2d},
            "b": {"conv3d_bn_relu": 18 * steps, "conv3d_input_grad": 17 * steps, "conv3d_wgrad": 18 * steps,
                  "bce_dice_sums": 0, "bce_dice_grads": 0, **none2d},
        }
        for key, extra in options.items():
            out_dir = work / f"runs_{key}"
            torch.cuda.reset_peak_memory_stats()
            zero_counters()
            t0 = time.perf_counter()
            out = train.main(base + [f"config.output_dir={out_dir}"] + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counters()
            check(got == want[key], f"[12{key}] train launches {got} != {want[key]}")
            (run,) = out_dir.glob("train-*/*")
            losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
                      if line.startswith("Loss: ")]
            check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"[12{key}] train losses {losses}")
            line = (f"[12{key}] train.main {' '.join(o.split('.', 1)[1] for o in extra)}: {steps} optimizer steps in "
                    f"{wall:.1f} s (data, validation and checkpoints included), launches {got} as derived, losses "
                    f"{[round(v, 5) for v in losses]}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if key == "a":
                ema_file, best_file = run / "ema_checkpoint.ckpt", run / "best_checkpoint.ckpt"
                check(ema_file.exists() and best_file.exists(), "[12a] ema_checkpoint.ckpt / best_checkpoint.ckpt")
                best, ema = checkpoint.load_checkpoint(best_file), checkpoint.load_checkpoint(ema_file)
                check(best["optimizer"] == "adamw" and best["opt_state"]["state"] and ema["opt_state"] is None,
                      "[12a] best has the optimizer state, the EMA file none")
                check(math.isfinite(out["best_val_dice"]), f"[12a] validation dice {out['best_val_dice']}")
                line += f"; validation dice {out['best_val_dice']:.4f}"
            print(line, flush=True)

        one = work / "one"
        for split in ("source", "label"):
            (one / split).mkdir(parents=True)
            os.symlink(work / "data" / split / "vol-00.nii.gz", one / split / "vol-00.nii.gz")
        zero_counters()
        predict.main(["config=unet", f"config.pred_data_path={one / 'source'}", f"config.pred_gt_path={one / 'label'}",
                      f"config.output_dir={work / 'pred_ema'}", f"config.ckpt={ema_file}"] + base[5:8])
        got = read_counters()
        check(got["conv3d_bn_relu"] == 18 * -(-n_tiles // BATCH), f"[12] predict from the EMA file: launches {got}")
        (pred_run,) = (work / "pred_ema").glob("predict-*/*")
        print(f"[12] predict.main from ema_checkpoint.ckpt: {(pred_run / 'metrics.csv').read_text().splitlines()[1]}",
              flush=True)

        # warm steps and peak memory by option: remat off / full / conv, grad_accum 1 / 2
        cfg = compose(base + [f"config.output_dir={work / 'runs_a'}"], job_name="train", make_run_dir=False)
        dataset = make_dataset(cfg, is_train=True, device=dev)
        step_batches = []
        while len(step_batches) < 7:
            step_batches.extend(dataset)
        loss_fn = train.make_loss_and_metric(cfg)
        sd = random_state_dict(torch, UNet3D(1, 2, 32), SEED + 12)
        settings = (("remat off, grad_accum 1", False, "", 1, 18), ("remat full", True, "full", 1, 36),
                    ("remat conv", True, "conv", 1, 18), ("grad_accum 2", False, "", 2, 36))
        for label, remat, policy, accum, fwd_per_step in settings:
            net = UNet3D(1, 2, 32, dtype=torch.bfloat16, remat=remat, remat_policy=policy)
            net.load_state_dict(sd)
            net.to(dev).train()
            opt = train.make_optimizer(cfg, net.parameters())
            step = train.make_train_step(net, opt, loss_fn, accum)
            for xb, yb in step_batches[:2]:
                step(xb, yb)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = [f.launches for f in counters]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for xb, yb in step_batches[2:7]:
                step(xb, yb)
            end.record()
            end.synchronize()
            per_step = {f.__name__: (f.launches - b) / 5 for f, b in zip(counters, before)}
            check(per_step["conv3d_bn_relu"] == fwd_per_step and per_step["conv3d_wgrad"] == 18 * accum,
                  f"[12] {label}: launches per step {per_step}")
            print(f"[12] {card}: warm train step ({label}; bf16, f=32, {BATCH}x{PATCH}^3, Adam): "
                  f"{start.elapsed_time(end) / 5:.3f} ms, peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
                  f"GiB, conv launches per step {per_step['conv3d_bn_relu']:g} forward, "
                  f"{per_step['conv3d_input_grad']:g} input gradient, {per_step['conv3d_wgrad']:g} weight gradient",
                  flush=True)
            del net, opt, step
            torch.cuda.empty_cache()
        del dataset, step_batches
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (a)'s optimizer settings with loss=focal, one step, f32, card vs CPU, as [8]
    cfg = ConfigDict(out_classes=2, loss="focal", optimizer="adamw", weight_decay=0.01, grad_clip=1.0, init_lr=1e-3)
    rng = np.random.default_rng(SEED + 12)
    xs = torch.from_numpy(rng.normal(size=(4, 32, 32, 32, 1)).astype(np.float32))
    ys = torch.from_numpy((rng.uniform(size=(4, 32, 32, 32, 1)) > 0.7).astype(np.float32))
    sd = random_state_dict(torch, UNet3D(1, 2, 8), SEED + 12)
    results = []
    for device in (torch.device("cpu"), dev):
        net = UNet3D(1, 2, 8)
        net.load_state_dict(sd)
        net.to(device).train()
        opt = train.make_optimizer(cfg, net.parameters())
        seen = {}
        opt.register_step_pre_hook(  # after make_optimizer's clip hook: the clipped mean gradient
            lambda o, a, k: seen.update({n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()}))
        ema = optim.EMA(net, 0.99)
        loss, _ = train.make_train_step(net, opt, train.make_loss_and_metric(cfg), 2)(xs.to(device), ys.to(device))
        ema.update(net)
        results.append((loss.item(), seen, {n: p.detach().cpu() for n, p in net.named_parameters()},
                        {n: t.cpu() for n, t in ema.state_dict(net).items()}))
    (cpu_loss, cpu_grads, cpu_params, cpu_ema), (gpu_loss, gpu_grads, gpu_params, gpu_ema) = results
    check(abs(gpu_loss - cpu_loss) <= 1e-5 * cpu_loss, f"[12] focal step loss card {gpu_loss} vs CPU {cpu_loss}")
    # held as [11] holds its gradients, in relative L2 norm: at two samples a microbatch a ReLU
    # mask flips where a pre-activation sits within f32 noise of 0 (on the CPU, weights moved by
    # 1e-6 of themselves move this step's gradients by up to 9e-4 of a tensor's largest entry)
    worst = worst_max = bias_worst = 0.0
    for name, want_g in cpu_grads.items():
        got_g = gpu_grads[name]
        if name.endswith("conv.bias"):
            bias_worst = max(bias_worst, (got_g - want_g).abs().max().item())
        else:
            worst = max(worst, ((got_g - want_g).norm() / want_g.norm()).item())
            worst_max = max(worst_max, (got_g - want_g).abs().max().item() / want_g.abs().max().item())
    check(worst <= 1e-2 and bias_worst <= 1e-5, f"[12] clipped gradients card vs CPU: {worst}, conv biases {bias_worst}")
    # AdamW's first step moves each weight by lr * g / (|g| + eps) (and the decay, the same on both):
    # about lr times the sign of g, so where the two gradients differ in sign the weights part by up
    # to 2 lr. Each side's weights must be its own gradient's step: their difference is
    # lr * (u(g_cpu) - u(g_card)) to rounding
    lr = cfg.init_lr

    def adam_first(g):
        return g / (g.abs() + 1e-8)

    diffs = torch.cat([(gpu_params[n] - cpu_params[n]).flatten() for n in cpu_params])
    explained = torch.cat([lr * (adam_first(cpu_grads[n]) - adam_first(gpu_grads[n])).flatten() for n in cpu_params])
    unexplained = (diffs - explained).abs().max().item()
    ema_diff = max((gpu_ema[n] - cpu_ema[n]).abs().max().item() for n in cpu_params)
    flipped = (diffs.abs() > 1e-3 * lr).float().mean().item()
    check(diffs.abs().max().item() <= 2 * lr * 1.001 and unexplained <= 1e-3 * lr and ema_diff <= 0.02 * lr * 1.001,
          f"[12] step card vs CPU: weights max|diff| {diffs.abs().max().item()}, beyond the gradients' steps "
          f"{unexplained}, EMA {ema_diff}")
    print(f"[12] UNet3D f=8 f32 step of adamw (wd 0.01) + clip 1.0 + grad_accum 2 + EMA 0.99, loss=focal, card vs "
          f"CPU: loss {gpu_loss:.6f} vs {cpu_loss:.6f}; clipped mean gradient worst error {worst:.3g} (relative L2; "
          f"{worst_max:.3g} of the tensor's largest entry), conv biases {bias_worst:.3g}; weights max|diff| "
          f"{diffs.abs().max().item():.3g} (lr {lr:g}), {100 * flipped:.3f}% of them more than 1e-3 lr apart, "
          f"{unexplained:.3g} beyond what the two gradients' AdamW steps give; EMA max|diff| {ema_diff:.3g}", flush=True)

    def entry(name, source, replaces, ms, plain_ms, bound, bound_by, library_ms, err, **extra):
        return {"name": name, "route": "cuda", "source": f"{PORT}/csrc/{source}",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms, **extra}

    bf = totals[torch.bfloat16]
    dg, wg = bw["bfloat16"]["dgrad"], bw["bfloat16"]["wgrad"]
    print(json.dumps({"kernels": [
        entry("conv3d_bn_relu", "conv3d_bn_relu.cu",
              f"{JAX_SRC}/ops/pallas_conv.py:122; {JAX_SRC}/ops/pallas_conv.py:217; "
              f"{JAX_SRC}/ops/pallas_tlayout.py:264; {JAX_SRC}/ops/pallas_tlayout.py:481",
              bf[0], bf[1], bf[3], bound_ms(fwd_ops, fwd_bytes, "bfloat16")[1], bf[2], max_err),
        entry("conv3d_input_grad", "conv3d_bn_relu.cu",
              f"{JAX_SRC}/ops/pallas_conv.py:122 (the input gradient at :271); "
              f"{JAX_SRC}/ops/pallas_tlayout.py:264 (the input gradient at :859)",
              dg[0], dg[1], dg[3], bound_ms(dgrad_ops, dgrad_bytes, "bfloat16")[1], dg[2], dgrad_err),
        entry("conv3d_wgrad", "conv3d_wgrad.cu", f"{JAX_SRC}/ops/pallas_tlayout.py:806",
              wg[0], wg[1], wg[3], bound_ms(wgrad_ops, wgrad_bytes, "bfloat16")[1], wg[2], wgrad_err),
        entry("bce_dice_sums", "fused_bce_dice.cu", f"{JAX_SRC}/ops/fused.py:81",
              loss_rows["sums"][0], loss_rows["sums"][1], loss_rows["sums"][2], loss_rows["sums"][3], None,
              loss_errs["sums"], wrapper_ms=loss_rows["sums"][4]),
        entry("bce_dice_grads", "fused_bce_dice.cu", f"{JAX_SRC}/ops/fused.py:125",
              loss_rows["grads"][0], loss_rows["grads"][1], loss_rows["grads"][2], loss_rows["grads"][3], None,
              loss_errs["grads"], wrapper_ms=loss_rows["grads"][4]),
        *(entry(name, src, replaces, *t2d["bfloat16"][key][:2], t2d["bfloat16"][key][3],
                bound_ms(*work2d[key], "bfloat16")[1], t2d["bfloat16"][key][2], err2d[key])
          for name, src, key, replaces in (
              ("conv2d_bn_relu", "conv3d_bn_relu.cu", "fwd", f"{JAX_SRC}/ops/pallas_tlayout.py:562"),
              ("conv2d_input_grad", "conv3d_bn_relu.cu", "dgrad",
               f"{JAX_SRC}/ops/pallas_tlayout.py:562 (the input gradient of its custom VJP at :613)"),
              ("conv2d_wgrad", "conv3d_wgrad.cu", "wgrad",
               f"{JAX_SRC}/ops/pallas_tlayout.py:806 (its KD = 1 instance; the JAX package's 2-D weight gradient "
               f"is XLA's, _wgrad2d_tlayout at :591)"),
          )),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
