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
   volumes, pipelined (loader thread, two writers). The conv kernel's
   launch count must be 18 per forward batch.
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
13. The predict options at ``config=unet``'s full width (f=32, bf16, patch
   64^3, overlap 4,4,36, batch 16) on [3]'s volumes and checkpoint (the same
   seeds): the warm time a volume and the conv launches (counter deltas) of
   the sliding window in crop mode (on the card, and fetched to the host),
   with ``blend`` mean_logits and average (the host aggregator), under
   ``tta=flips`` (8 x 18 launches a batch), and of the whole-volume forward
   (18 a volume), with its peak memory; the crop mask's fetch to the host
   as int8 through pinned memory against the bit-packed bytes of the JAX
   package's ``_pack_bits`` unpacked on the host (the same int32 mask);
   ``shape_bucket=32`` on a 250x243x121 crop of a volume gives the
   unbucketed mask byte for byte; the eval conv kernel in bf16 against its
   plain version with [2]'s limits at each of the whole-volume forward's 18
   shapes (batch 1, 256x256x128 halved per pooling level, the stem's 1->32
   to 512 channels at 16x16x8), with its time, the plain version's and the
   bound, and 64->32 at 1x512x512x256 (an input of 4.3e9 elements) on three
   depth planes at each end and where the input's element offsets pass
   2^31, each from its slab with a one-plane halo; f32 masks card vs CPU
   for every option at UNet3D f=8 on a 96x96x64 volume (agreement at least
   99.9%, logits within 1e-3 of their scale); UNet2D from [10]'s checkpoint
   through ``predict.main`` with ``tta=flips:hw`` (4 x [10]'s launches) and
   ``whole_volume=true`` (the warning, then [10]'s mask); ``train.main`` as
   [12] with validation by the whole volume; ``predict.main`` with
   ``tta=flips blend=mean_logits shape_bucket=32`` and with
   ``whole_volume=true`` on [3]'s two volumes, end to end.

14. Serving at ``config=unet``'s full width (f=32, bf16, patch 64^3, overlap
   4,4,36, batch 16) on [3]'s volumes and checkpoint (the same seeds):
   ``serving.main`` with ``serve_once=true`` over a watch directory of the
   two volumes (in-process): its masks equal [3]'s ``predict.main`` masks
   byte for byte, 126 ``conv3d_bn_relu`` launches a volume and no 2-D one,
   each volume's time split into read, predict and write; a second
   ``serve_once`` over the same run directory returns {} and launches
   nothing. A warm ``Predictor``: ``predict_prepared`` (the card and the
   fetch) and ``prepare`` per volume, crop and whole volume (126 and 18
   launches). The export of both programs at 256x256x128 through
   ``serving.main``'s export mode (time, bytes, no launch), then both
   artifacts loaded and run in one subprocess that blocks the port's
   ``models`` and ``nn`` packages (and JAX): its masks equal the
   Predictor's, its own launch counts are 126 and 18. A UNet2D
   ``Predictor`` from [10]'s checkpoint gives [10]'s mask with 864
   ``conv2d_bn_relu`` launches. Then the eval conv through its registered
   operator against the direct call (eager predict's), alternated: host
   microseconds per call, and UNet2D's sliding window on the card.
15. The 3-D zoo at full width: res_unet, vnet, highresnet, csrnet, er_net,
   re_net, IS, dunet, fusionnet, densevoxelnet, densenet, fcn3d and the
   transformers unetr and vtnet, each at its JAX ``from_config`` width,
   bf16, Adam, device data on [10]'s two 256x256x128 volumes (those of
   [3]). ``train.main`` for 2 steps of 16 x 64^3: finite losses, and per
   step exactly the ``conv3d_bn_relu`` / ``conv3d_input_grad`` /
   ``conv3d_wgrad`` launches of the network's k3 s1 p1 convs (``ZOO``;
   PERF.md section 6 derives them) and one of each loss kernel; a warm step
   by CUDA events and the peak memory. ``predict.main`` from that
   checkpoint on one 128x128x64 volume (reduced from 256x256x128 so that
   twelve gzip-9 mask writes fit the run): the mask's shape and the eval
   convs a volume; the seconds end to end and of the sliding window alone
   on the card (for IS also, alternated with it, the window of a forward
   that runs the bands' decoders too, which out1 does not read; densevoxelnet's
   eval forward runs its first dense block alone, 12 of its 24 convs); fcn3d's
   whole-volume forward over one 256x256x128 volume (its p60 stem makes
   374x374x246 x 8 maps): its time, peak memory and 11 launches; VT-UNet's
   whole-volume forward over the same volume (time, peak memory, the
   mask's shape; no conv launch). For unetr and vtnet one warm train step
   at their config's own 128^3 patch, at the largest batch of 16, 8, 4, 2,
   1 that fits on the card: the batch, the ms and the peak GiB. Each k3 s1
   p1 conv shape the fourteen bring at 16 x 64^3 and
   its pooled sizes that UNet3D's 18 ([2], [6]) lack, the ragged stems
   (Cin 3 and 4), densevoxelnet's Cout-12 dense layers and fcn3d's 8->8 at
   182^3 among them, in bf16 against the plain versions with
   [2]'s and [6]'s limits: forward, input gradient (not for a 1-channel
   stem, whose input is data) and weight gradient, with the kernel, plain,
   cuDNN and bound times. Each network at a narrow width (or its fixed
   one) on 32^3 in f32, card against CPU, logits within 1e-3 of their
   scale (UNETR at embed 32, 4 heads; VT-UNet at embed 12, window 4). ER-Net
   (bare TorchConvs) exported by the whole volume at 128x128x64, loaded, the
   Predictor's mask with 14 eval conv launches; VT-UNet's crop program
   (its roll, window partition and shift masks) exported at 128x128x64,
   loaded, the Predictor's mask.
16. The 2-D zoo at full width: highres2dnet, segnet, unetpp, fcn2d,
   deeplab, pspnet and miniseg at the unet2d defaults (patch 1,128,128,
   batch 16, bf16, Adam, device data) on [10]'s volumes: ``train.main`` for 2 steps with exactly the
   ``conv2d_bn_relu`` / ``conv2d_input_grad`` / ``conv2d_wgrad`` launches of
   the network's k3 s1 p1 convs (``ZOO2D``) and no 3-D conv; a warm step
   by CUDA events and the peak memory; ``predict.main`` on one volume of
   64 slices of 128^2 (the launches a batch, the mask); each new 2-D conv
   shape against its plain version and cuDNN as in [15]; f32 logits card
   against CPU on 2 x 1 x 64^2.

17. The data backends and the epoch graph at full width, on [10]'s two
   256x256x128 volumes: ``data/device_aug.augment_pair`` on the card, warm,
   in ms per volume for the affine and the elastic branch (CUDA events: its
   steps up to the OneOf, then each branch on their output), with
   the host stack (``transforms.build_transform(aug=true)`` and each branch)
   in s on one volume; the affine and elastic resamples with fixed
   parameters on the card against the CPU (images within 1e-4 of their
   scale, labels binary and agreeing on at least 99.9% of the voxels).
   ``train.main config=unet aug=true`` (device backend) for 2 epochs of 2
   steps of 16 x 64^3: finite losses, [7]'s launches a step, and an epoch's
   augmentation time. ``train.main config=unet epoch_scan=true`` for 2
   epochs of 4 steps with ``scheduler_step_size=1 scheduler_gamma=0``:
   finite losses; step 0 runs eagerly (the warm-up before the capture) and
   the wrappers count its launches, [7]'s a step; the other 7 steps replay
   the graph, past the wrappers: one replay of the run's own graph, profiled,
   launches by name what the eager step launched, and each of the 7 adds
   that step's launches (``replayed_launches``); every
   parameter of ``checkpoint_0002.ckpt`` equal to ``checkpoint_0001.ckpt``'s
   bit for bit (lr 0 reached the replays) while BatchNorm's statistics
   moved; a per-step ``train.main`` resumes that checkpoint (the graph's
   capturable Adam) for a third epoch. For unet and unet2d, three copies of
   the model from the same init, one epoch function each
   (``ops/epoch_scan.make_epoch_scan``): the graph and two eager loops of
   the same step on the same plans, ms per step by CUDA events over an
   epoch of 4 replays, in turns (graph, eager, eager, graph); the first
   replayed step's loss within 1e-3 (relative) of the eager loop's; the
   weights after the first epoch no further from the eager loop's, in
   relative L2, than twice the two eager loops' distance plus 1e-6 (UNet2D's
   step is not reproducible run to run, UNet3D's is bit for bit), with the
   operations torch flags as not reproducible in one eager step, the two
   eager loops' distance under SGD, and the spread of UNet2D's bilinear
   upsampling backward run twice on the same inputs; one
   replay's hand kernels counted by name under ``torch.profiler`` equal to
   one eager step's (unet: 35 conv, 18 wgrad, 1 + 1 loss at KD = 3; unet2d
   the same at KD = 1). res_unet (Dropout 0.6) under ``epoch_scan``:
   ``train.main`` for an epoch of 2 steps (step 0 eager, one replay, counted
   as above) with finite losses, and 3 replays of its graph, whose dropped
   positions (a forward hook captured with the step) differ from replay to
   replay at every level. ``data_backend=grain grain_workers=2``: the first
   batch equals ``grain_workers=0``'s, pinned; the loader alone in batches
   per second; ``train.main`` for an epoch of 2 steps.

Phases [3], [7], [10], [12], [13], [14], [15], [16] and [17]'s train, predict and serve runs are the main paths:
every launch counter is set to 0 just before each and read just after; a
kernel's ``launches`` in the kernel line is the sum over all of them, with
the launches of an ``epoch_scan`` run's replays (a wrapper counts only what
it launches, not what it records into a graph under capture). The kernel line's times are sums over the
convs of one train step: conv3d_bn_relu the 18 forward convs, conv3d_input_grad
the 17 input gradients, conv3d_wgrad the 18 weight gradients (bf16), at
UNet3D's shapes; conv2d_* the same at UNet2D's; the loss kernels' ``ms`` is
their device time per call at UNet3D's logits in [5] (the profiler's; up to
their redesign it was the wrapper's time, host included), with their
wrapper's time beside it as ``wrapper_ms`` and the largest error of the
three shapes of [5]; the conv kernels' ``max_abs_err`` is the largest of
[2], [6] and [15] (the 2-D ones: [9] and [16]). Bounds (``bound_ms``) are the larger of
the bytes the work must move (each input read once, each output written
once) over 3.35 TB/s and its FLOPs over 989 TFLOP/s (bf16 tensor cores)
or 67 TFLOP/s (f32 on CUDA cores), the H100 SXM data-sheet peaks.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
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
ODD_CROP = (250, 243, 121)  # [13]'s shape_bucket check: a crop of a [3] volume
BIG_CONV = ((1, 512, 512, 256), 64, 32)  # [13]: (N, D, H, W), Cin, Cout of a conv input past 2^31 elements
INT32_ELEMENTS = 2**31  # [13]: a conv input with more elements is checked on slabs
SMALL_VOLUME = (96, 96, 64)  # [13]'s f32 card-vs-CPU volume
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0
ZOO_VOLUME = (128, 128, 64)  # [15]'s predict volume, reduced from VOLUME so that twelve gzip-9 mask writes fit
ZOO_SAMPLES = 16  # [15]: 2 volumes x 16 patches = 2 train steps of 16
# [15]: k3 s1 p1 conv launches of one train step (forward, input gradient, weight gradient) and of one
# forward batch in predict (the first, but for IS, whose eval forward runs its encoder and first decoder
# alone, and densevoxelnet, whose eval forward runs its first dense block alone). The derivation is in
# PERF.md section 6.
ZOO = {
    "res_unet": (19, 18, 19, 19), "vnet": (0, 0, 0, 0), "highresnet": (7, 6, 7, 7), "csrnet": (18, 17, 18, 18),
    "er_net": (14, 13, 14, 14), "re_net": (14, 13, 14, 14), "IS": (54, 17, 18, 18), "dunet": (28, 27, 28, 28),
    "fusionnet": (20, 19, 20, 20), "densevoxelnet": (24, 12, 12, 12), "densenet": (19, 18, 19, 19),
    "fcn3d": (11, 11, 11, 11), "unetr": (17, 16, 17, 17), "vtnet": (0, 0, 0, 0),
}
TRANSFORMERS = ("unetr", "vtnet")  # [15]: a warm step at their config's 128^3 patch, the largest batch that fits
CONFIG_BATCHES = (16, 8, 4, 2, 1)
# [15]'s f32 card-vs-CPU models: the class's arguments at a narrow width (the fixed-width nets at theirs)
ZOO_NARROW = {
    "res_unet": (1, 2, 8), "vnet": (True, 1, 2), "highresnet": (1, 2), "csrnet": (1, 2, 8), "er_net": (2, 1),
    "re_net": (1,), "IS": (1, 2, 8), "dunet": (1, 2, 16), "fusionnet": (1, 2, 8, 8), "densevoxelnet": (1, 2),
    "densenet": (1, 2), "fcn3d": (1, 2),
    "unetr": ((32, 32, 32), 1, 2, 32, 16, 4), "vtnet": (2, 1, 12, 4),  # the JAX tests' narrow sizes (test_zoo.py)
}
# [16]: the 2-D zoo's k3 s1 p1 conv launches (conv2d_*), as ZOO's; all at their fixed widths. fcn2d's first
# conv (p100) and the strided, dilated, grouped and depthwise convs of the others take cuDNN
ZOO2D = {"highres2dnet": (7, 6, 7, 7), "segnet": (26, 25, 26, 26), "unetpp": (59, 59, 59, 59),
         "fcn2d": (12, 12, 12, 12), "deeplab": (30, 30, 30, 30), "pspnet": (20, 20, 20, 20), "miniseg": (2, 2, 2, 2)}
ZOO2D_VOLUME = (64, SLICE, SLICE)  # [16]'s predict volume: 64 slices of 1 x 128 x 128, 4 batches of 16


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


def write_volumes(root, io, shape=VOLUME, count=N_VOLUMES):
    """Bright-ball volumes: label = ball, image = 2*label + N(0, 0.3)."""
    for split in ("source", "label"):
        (root / split).mkdir(parents=True)
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij"))
    for i in range(count):
        rng = np.random.default_rng(SEED + 100 + i)
        center = rng.uniform(0.3, 0.7, 3) * np.asarray(shape)
        radius = rng.uniform(20, 40) * min(shape) / min(VOLUME)
        label = (np.sqrt(((grid - center[:, None, None, None]) ** 2).sum(0)) < radius).astype(np.float32)
        image = label * 2.0 + rng.normal(0, 0.3, shape).astype(np.float32)
        io.write_nifti(root / "source" / f"vol-{i:02d}.nii.gz", io.Volume(image[None]))
        io.write_nifti(root / "label" / f"vol-{i:02d}.nii.gz", io.Volume(label[None]))


def predict_options(torch, dev, card, zero_counters, read_counters, unet2d_run, e2e_per_volume):
    """Phase [13]: the predict options at full width (see the module docstring)."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch import checkpoint, predict, train
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io, pipeline, transforms
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu as conv
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import sliding_window as sw

    kernel, plain, kernel2d = conv.conv3d_bn_relu, conv.conv3d_bn_relu_reference, conv.conv2d_bn_relu
    t_phase = time.perf_counter()
    patch = (PATCH,) * 3
    work = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build"))
    try:
        write_volumes(work / "data", io)  # [3]'s volumes and checkpoint: the same seeds
        ckpt = work / "unet3d.pt"
        checkpoint.save_checkpoint(ckpt, random_state_dict(torch, UNet3D(1, 2, 32), SEED), epoch=0)
        net = UNet3D(1, 2, 32, dtype=torch.bfloat16)
        net.load_state_dict(checkpoint.load_checkpoint(ckpt)["params"])
        net.to(dev).eval()
        subject = pipeline.load_subject((work / "data" / "source" / "vol-00.nii.gz",
                                         work / "data" / "label" / "vol-00.nii.gz"))
        vol = sw.prepare_volume(transforms.ZNormalization().normalize_array(subject.source.data), dev, torch.bfloat16)
        batches = -(-len(pipeline.grid_locations(VOLUME, patch, OVERLAP)) // BATCH)
        tta = predict.make_forward_fn(ConfigDict(network="unet", tta="flips"), net)

        # warm time a volume and conv launches by option (counter deltas: not the main path's)
        options = {
            "crop": (lambda: sw.sliding_window_predict(net, vol, patch, OVERLAP, BATCH), 18 * batches),
            "crop, fetched to the host": (
                lambda: sw.sliding_window_predict(net, vol, patch, OVERLAP, BATCH, sync=False)(), 18 * batches),
            "blend=mean_logits": (
                lambda: sw.sliding_window_predict(net, vol, patch, OVERLAP, BATCH, overlap_mode="mean_logits"),
                18 * batches),
            "blend=average (host aggregator)": (
                lambda: sw.sliding_window_predict(net, vol, patch, OVERLAP, BATCH, overlap_mode="average")(),
                18 * batches),
            "tta=flips": (lambda: sw.sliding_window_predict(tta, vol, patch, OVERLAP, BATCH), 8 * 18 * batches),
            "whole_volume": (lambda: sw.whole_volume_predict(net, vol, pad_multiple=16), 18),
            "whole_volume, fetched to the host": (
                lambda: sw.whole_volume_predict(net, vol, pad_multiple=16, sync=False)(), 18),
        }
        for label, (run, want) in options.items():
            run()
            torch.cuda.synchronize()
            times, before = [], kernel.launches
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            check(kernel.launches - before == 3 * want, f"[13] {label}: {kernel.launches - before} launches, not 3 x {want}")
            print(f"[13] {card}: {label}: {', '.join(f'{v:.4f}' for v in times)} s a volume {VOLUME}, "
                  f"{want} conv3d_bn_relu launches", flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        whole = sw.whole_volume_predict(net, vol, pad_multiple=16)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        crop = sw.sliding_window_predict(net, vol, patch, OVERLAP, BATCH)
        agree = (whole == crop).float().mean().item()
        print(f"[13] whole_volume peak memory {peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} GiB above the "
              f"{resident / 2**30:.3f} GiB of weights and volume); its mask agrees with crop's on {agree:.6f} of the "
              f"voxels", flush=True)

        # the crop mask's fetch to the host as the JAX package's int32 [1, X, Y, Z]: int8 through pinned
        # memory, against the bytes of the JAX _pack_bits (8x fewer; bit j of byte i is voxel 8i + j)
        # unpacked on the host; alternated, 5 calls each after a warm-up
        bit = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=dev)

        def fetch(packed):
            src = crop
            if packed:
                src = (crop.view(*crop.shape[:2], -1, 8).to(torch.uint8) * bit).sum(-1, dtype=torch.uint8)
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            arr = host.numpy()
            if packed:
                arr = np.unpackbits(arr.reshape(-1), bitorder="little").reshape(crop.shape).view(np.int8)
            return arr[None].astype(np.int32)

        check(np.array_equal(fetch(False), fetch(True)), "[13] the bit-packed fetch gives another mask")
        fetch_ms = {False: [], True: []}
        for _ in range(5):
            for packed in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fetch(packed)
                fetch_ms[packed].append(1e3 * (time.perf_counter() - t0))
        print(f"[13] {card}: the crop mask's fetch to the host ({'x'.join(map(str, VOLUME))}, int32 out): int8 "
              f"{', '.join(f'{v:.3f}' for v in fetch_ms[False])} ms; bit-packed and unpacked on the host "
              f"{', '.join(f'{v:.3f}' for v in fetch_ms[True])} ms", flush=True)

        # shape_bucket=32 on an odd-shaped crop: the unbucketed mask, byte for byte
        odd = vol[:ODD_CROP[0], :ODD_CROP[1], :ODD_CROP[2]].contiguous()
        unbucketed = sw.sliding_window_predict(net, odd, patch, OVERLAP, BATCH, sync=False)()
        padded = sw.pad_volume(odd, 32)
        bucketed = sw.sliding_window_predict(net, padded, patch, OVERLAP, BATCH, true_spatial=ODD_CROP, sync=False)()
        check(bucketed.shape == (1, *ODD_CROP) and bucketed.tobytes() == unbucketed.tobytes(),
              "[13] shape_bucket=32: the mask differs from the unbucketed one")
        print(f"[13] shape_bucket=32 on a {'x'.join(map(str, ODD_CROP))} crop (padded to "
              f"{'x'.join(map(str, padded.shape[:3]))} on the card): the unbucketed mask byte for byte "
              f"({int(bucketed.sum())} foreground voxels)", flush=True)
        widths = [tuple(block.conv.weight.shape[3:]) for block in net.blocks]
        del net, vol, tta, whole, crop, odd, padded

        # the eval conv kernel at the whole-volume forward's 18 shapes (batch 1, the 256x256x128 volume
        # needs no padding to 16 and halves per pooling level) and at 1x512x512x256, against its plain version
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        shapes = [((1, *(s >> level for s in VOLUME)), cin, cout) for (cin, cout), level in zip(widths, LEVELS)]
        sums = [0.0, 0.0, 0.0]
        for i, (shape, cin, cout) in enumerate([*shapes, BIG_CONV]):
            w, b = conv.fold_batchnorm(
                torch.randn(3, 3, 3, cin, cout, device=dev, generator=gen) * (27 * cin) ** -0.5,
                0.1 * torch.randn(cout, device=dev, generator=gen), 0.5 + torch.rand(cout, device=dev, generator=gen),
                0.1 * torch.randn(cout, device=dev, generator=gen), 0.1 * torch.randn(cout, device=dev, generator=gen),
                0.5 + 1.5 * torch.rand(cout, device=dev, generator=gen))
            w = w.to(torch.bfloat16)
            x = torch.randn((*shape, cin), device=dev, generator=gen, dtype=torch.bfloat16)
            y = kernel(x, w, b)
            torch.cuda.synchronize()
            k_ms = cuda_ms(torch, lambda: kernel(x, w, b), reps=3)
            b_ms = bound_ms(*conv_work(math.prod(shape), cin, cout, 2), "bfloat16")[0]
            if x.numel() < INT32_ELEMENTS:  # the whole conv
                want = plain(x.float(), w.float(), b)
                planes = "all planes"
                p_ms = cuda_ms(torch, lambda: plain(x, w, b), reps=3)
                err = (y.float() - want).abs().max().item()
                limit = BF16_TOL * max(1.0, want.abs().max().item())
            else:  # 3 depth planes at each end and where x's element offsets pass 2^31, each from its slab + halo
                d = shape[1]
                mid = INT32_ELEMENTS // (cin * shape[2] * shape[3])
                err, limit, p_ms = 0.0, 0.0, float("nan")
                for lo, hi in ((0, 3), (mid - 1, mid + 2), (d - 3, d)):
                    s0, s1 = max(lo - 1, 0), min(hi + 1, d)
                    want = plain(x[:, s0:s1].float(), w.float(), b)[:, lo - s0:hi - s0]
                    err = max(err, (y[:, lo:hi].float() - want).abs().max().item())
                    limit = max(limit, BF16_TOL * max(1.0, want.abs().max().item()))
                planes = f"depth planes 0-2, {mid - 1}-{mid + 1}, {d - 3}-{d - 1}"
            check(err <= limit, f"[13] conv {cin}->{cout} at {shape}: max|kernel-plain| {err} > {limit}")
            name = f"whole-volume ConvBlock_{i:<2d}" if i < len(shapes) else "conv past 2^31 elements"
            print(f"[13] {name} {cin:>3d}->{cout:<3d} at {'x'.join(map(str, shape))} bf16 ({x.numel():,} input "
                  f"elements): err {err:.3g} (limit {limit:.3g}) on {planes}; kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms, bound {b_ms:.4f} ms", flush=True)
            if i < len(shapes):
                sums = [t + v for t, v in zip(sums, (k_ms, p_ms, b_ms))]
            del x, y, want, w, b
            torch.cuda.empty_cache()
        print(f"[13] sum of the whole-volume forward's 18 convs, bf16: kernel {sums[0]:.3f} ms, plain {sums[1]:.3f} "
              f"ms, bound {sums[2]:.4f} ms", flush=True)

        # f32 masks, card vs CPU, for every option at a small size (UNet3D f=8, a 96x96x64 volume)
        small = SMALL_VOLUME
        rng = np.random.default_rng(SEED + 13)
        grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in small], indexing="ij"))
        center = 0.4 * np.asarray(small, dtype=np.float32)
        ball = (np.sqrt(((grid - center[:, None, None, None]) ** 2).sum(0)) < small[2] / 3).astype(np.float32)
        src = transforms.ZNormalization().normalize_array((2.0 * ball + rng.normal(0, 0.3, small))[None])
        sd = random_state_dict(torch, UNet3D(1, 2, 8), SEED + 13)
        small_patch, small_overlap = (32, 32, 32), (4, 4, 8)
        runs = []
        for device in (torch.device("cpu"), dev):
            m8 = UNet3D(1, 2, 8)
            m8.load_state_dict(sd)
            m8.to(device).eval()
            v8 = sw.prepare_volume(src, device, torch.float32)
            tta8 = predict.make_forward_fn(ConfigDict(network="unet", tta="flips"), m8)

            def window(model, mode="crop", v=v8, true=None):
                return sw.sliding_window_predict(model, v, small_patch, small_overlap, 4, overlap_mode=mode,
                                                 true_spatial=true, sync=False)()

            masks = {
                "crop": window(m8), "blend=mean_logits": window(m8, "mean_logits"),
                "blend=average": window(m8, "average"), "tta=flips": window(tta8),
                "shape_bucket=40": window(m8, v=sw.pad_volume(v8, 40), true=small),
                "whole_volume": sw.whole_volume_predict(m8, v8, pad_multiple=16, sync=False)(),
                "whole_volume + shape_bucket=40": sw.whole_volume_predict(m8, v8, pad_multiple=80, sync=False)(),
            }
            with torch.inference_mode():
                tiles = v8[None, :32, :32, :32].contiguous()
                logits = {"whole volume": m8(v8[None]).cpu(), "tta=flips tile": tta8(tiles).cpu()}
            runs.append((masks, logits))
        (cpu_masks, cpu_logits), (gpu_masks, gpu_logits) = runs
        for name, want in cpu_logits.items():
            got = gpu_logits[name]
            scale = max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            check(err <= 1e-3 * scale, f"[13] f32 {name} logits card vs CPU: max|diff| {err} > {1e-3 * scale}")
            print(f"[13] UNet3D f=8 f32 {name} logits card vs CPU: max|diff| {err:.3g} (logit scale {scale:.3g})",
                  flush=True)
        line = []
        for name, want in cpu_masks.items():
            got = gpu_masks[name]
            check(got.shape == want.shape == (1, *small) and got.dtype == want.dtype, f"[13] f32 {name} mask shape")
            agree = float((got == want).mean())
            check(agree >= 0.999 and 0 < float(want.mean()) < 1, f"[13] f32 {name} masks card vs CPU: {agree}")
            line.append(f"{name} {agree:.6f}")
        print(f"[13] UNet3D f=8 f32 masks on a {'x'.join(map(str, small))} volume, card vs CPU agreement: "
              + ", ".join(line), flush=True)

        # UNet2D from [10]'s checkpoint: tta=flips:hw, and whole_volume (the warning, then the sliding window)
        work2d, ckpt2d, one2d, mask2d, batches2d = unet2d_run
        for extra, want, label in (("config.tta=flips:hw", 4 * 18 * batches2d, "tta=flips:hw"),
                                   ("config.whole_volume=true", 18 * batches2d, "whole_volume=true")):
            out_dir = work / f"unet2d_{label}"
            zero_counters()
            t0 = time.perf_counter()
            predict.main(["config=unet2d", f"config.pred_data_path={one2d / 'source'}",
                          f"config.pred_gt_path={one2d / 'label'}", f"config.output_dir={out_dir}",
                          f"config.ckpt={ckpt2d}", f"config.patch_size=1, {SLICE}, {SLICE}",
                          f"config.batch_size={BATCH}", extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counters()
            check(got["conv2d_bn_relu"] == want and got["conv3d_bn_relu"] == 0, f"[13] unet2d {label}: launches {got}")
            (run,) = out_dir.glob("predict-*/*")
            (mask_file,) = (run / "pred_file").glob("pred-*.nii.gz")
            mask = io.read_volume(mask_file).data
            check(mask.shape == (1, *VOLUME), f"[13] unet2d {label} mask {mask.shape}")
            same = bool(np.array_equal(mask, io.read_volume(mask2d).data))
            if label == "whole_volume=true":
                check("whole_volume is 3-D only" in (run / "predict.log").read_text(), "[13] the 2-D warning")
                check(same, "[13] unet2d whole_volume=true: not [10]'s mask")
            print(f"[13] predict.main config=unet2d {label}: launches conv2d_bn_relu {got['conv2d_bn_relu']} "
                  f"({want // (18 * batches2d)} x [10]'s), {wall:.3f} s end to end, mask "
                  f"{'equal to' if same else 'unlike'} [10]'s", flush=True)

        # train.main of [12]'s kind with validation by the whole volume
        steps = N_VOLUMES * SAMPLES_PER_VOLUME // BATCH
        base = [
            "config=unet",
            f"config.data_path={work / 'data' / 'source'}", f"config.gt_path={work / 'data' / 'label'}",
            f"config.val_data_path={work / 'data' / 'source'}", f"config.val_gt_path={work / 'data' / 'label'}",
            f"config.patch_size={PATCH}, {PATCH}, {PATCH}", "config.patch_overlap=" + ", ".join(map(str, OVERLAP)),
            f"config.batch_size={BATCH}",
        ]
        zero_counters()
        t0 = time.perf_counter()
        out = train.main(base + [f"config.output_dir={work / 'train_wv'}", f"config.samples_per_volume={SAMPLES_PER_VOLUME}",
                                 "config.epochs=1", "config.epochs_per_checkpoint=1", "config.val_interval=1",
                                 "config.whole_volume=true"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counters()
        check(got["conv3d_bn_relu"] == 18 * steps + 18 * N_VOLUMES and got["conv3d_wgrad"] == 18 * steps,
              f"[13] train.main whole_volume validation: launches {got}")
        check(math.isfinite(out["best_val_dice"]), f"[13] validation dice {out['best_val_dice']}")
        print(f"[13] train.main, {steps} steps and validation by the whole volume: {wall:.1f} s, launches {got}, "
              f"validation dice {out['best_val_dice']:.4f}", flush=True)
        del out

        # predict.main with options on [3]'s two volumes
        for extra, want in ((["config.tta=flips", "config.blend=mean_logits", "config.shape_bucket=32"],
                             N_VOLUMES * 8 * 18 * batches),
                            (["config.whole_volume=true"], N_VOLUMES * 18)):
            out_dir = work / ("pred_" + "_".join(e.split(".", 1)[1] for e in extra))
            zero_counters()
            t0 = time.perf_counter()
            predict.main(base[:1] + base[5:] + [f"config.pred_data_path={work / 'data' / 'source'}",
                                                f"config.pred_gt_path={work / 'data' / 'label'}",
                                                f"config.output_dir={out_dir}", f"config.ckpt={ckpt}", *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counters()
            check(got["conv3d_bn_relu"] == want, f"[13] predict.main {extra}: launches {got}, not {want}")
            (run,) = out_dir.glob("predict-*/*")
            rows = (run / "metrics.csv").read_text().splitlines()
            check(len(rows) == N_VOLUMES + 2 and all(0.0 <= float(v) <= 1.0 for r in rows[1:-1]
                                                     for v in r.split(",")[:4]), f"[13] metrics.csv {rows}")
            masks = sorted((run / "pred_file").glob("pred-*.nii.gz"))
            check(len(masks) == N_VOLUMES and io.read_volume(masks[0]).data.shape == (1, *VOLUME), "[13] masks")
            print(f"[13] predict.main {' '.join(e.split('.', 1)[1] for e in extra)}: {N_VOLUMES} volumes, launches "
                  f"conv3d_bn_relu {got['conv3d_bn_relu']}, {wall / N_VOLUMES:.3f} s per volume end to end; "
                  f"metrics {rows[1:-1]}", flush=True)
        print(f"[13] predict.main crop ([3], pipelined): {e2e_per_volume:.3f} s per volume end to end; "
              f"[13] took {time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


_BLOCKED_LOAD = f"""
import json, sys, time
for name in ("jax", "flax", "{JAX_SRC}", "{PORT}.models", "{PORT}.nn"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from {PORT}.ops import conv3d_bn_relu as conv
from {PORT}.serving import load_exported_predictor
params, volume = torch.load(sys.argv[2]), np.load(sys.argv[3])
result = {{}}
for artifact, out in zip(sys.argv[4::2], sys.argv[5::2]):
    t0 = time.perf_counter()
    predict = load_exported_predictor(artifact)
    load_s, launches, times = time.perf_counter() - t0, [], []
    for _ in range(3):
        conv.conv3d_bn_relu.launches = 0
        t0 = time.perf_counter()
        mask = predict(params, volume)
        times.append(time.perf_counter() - t0)
        launches.append(conv.conv3d_bn_relu.launches)
    np.save(out, mask)
    result[artifact] = {{"load_s": load_s, "s": times, "launches": launches}}
blocked = [m for m in sys.modules if sys.modules[m] is not None
           and (m.split(".")[0] in ("jax", "flax", "{JAX_SRC}") or m.startswith(("{PORT}.models", "{PORT}.nn")))]
assert not blocked, blocked
print(json.dumps(result))
"""


def serving_phase(torch, card, zero_counters, read_counters, unet2d_run, predict_masks):
    """Phase [14]: serving at full width (see the module docstring)."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch import checkpoint, serving
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io, transforms
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
    from general_medical_image_segmentation_cnn_framework_tpu_torch.nn import blocks
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu as conv
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import sliding_window as sw

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build"))
    read, write, predict_array = serving.read_volume, serving.write_volume, serving.Predictor.predict_array
    direct2d = blocks.conv2d_bn_relu
    try:
        write_volumes(work / "data", io)  # [3]'s volumes and checkpoint: the same seeds
        ckpt = work / "unet3d.pt"
        checkpoint.save_checkpoint(ckpt, random_state_dict(torch, UNet3D(1, 2, 32), SEED), epoch=0)
        watch = work / "data" / "source"
        argv = ["config=unet", f"config.ckpt={ckpt}", f"config.output_dir={work / 'serve'}",
                f"config.patch_size={PATCH}, {PATCH}, {PATCH}", "config.patch_overlap=" + ", ".join(map(str, OVERLAP)),
                f"config.batch_size={BATCH}", "config.precision=bfloat16"]
        per_batch = 18 * -(-len(sw.grid_locations(VOLUME, (PATCH,) * 3, OVERLAP)) // BATCH)

        # serving.main, serve_once over the watch directory, each volume's time split by timed wrappers
        split = {"read": [], "predict": [], "write": []}

        def timed(key, fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                split[key].append(time.perf_counter() - t0)
                return out
            return run

        serving.read_volume, serving.write_volume = timed("read", read), timed("write", write)
        serving.Predictor.predict_array = timed("predict", predict_array)
        zero_counters()
        t0 = time.perf_counter()
        done = serving.main([*argv, f"config.watch_dir={watch}", "config.serve_once=true"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counters()
        serving.read_volume, serving.write_volume, serving.Predictor.predict_array = read, write, predict_array
        names = [f"vol-{i:02d}.nii.gz" for i in range(N_VOLUMES)]
        check(sorted(done) == names, f"[14] serve_once returned {done}")
        check(got["conv3d_bn_relu"] == N_VOLUMES * per_batch and got["conv2d_bn_relu"] == 0,
              f"[14] serve_once launches {got}, not {per_batch} a volume")
        for name, want in zip(names, predict_masks):
            served, batch = io.read_volume(done[name]), io.read_volume(want)
            check(served.data.tobytes() == batch.data.tobytes() and np.array_equal(served.affine, batch.affine),
                  f"[14] the served mask of {name} differs from predict.main's {want.name}")
        print(f"[14] {card}: serving.main serve_once, {N_VOLUMES} volumes {VOLUME}: {wall:.3f} s, launches "
              f"conv3d_bn_relu {got['conv3d_bn_relu']} ({per_batch} a volume), conv2d_bn_relu {got['conv2d_bn_relu']}; "
              f"masks equal to predict.main's byte for byte; per volume read "
              f"{', '.join(f'{v:.3f}' for v in split['read'])} s, predict (z-normalise, upload, card, fetch) "
              f"{', '.join(f'{v:.3f}' for v in split['predict'])} s, write "
              f"{', '.join(f'{v:.3f}' for v in split['write'])} s", flush=True)
        cfg = compose([*argv, f"config.watch_dir={watch}"], job_name="serve", make_run_dir=False)
        cfg.hydra_path = str(Path(done[names[0]]).parents[1])  # the first run's directory: a restart
        zero_counters()
        again = serving.serve(cfg, once=True)
        got = read_counters()
        check(again == {} and not any(got.values()), f"[14] the second serve_once returned {again}, launches {got}")
        print("[14] a second serve_once over the same directory: {} and no launch", flush=True)

        # warm Predictor: the host's preparation and the device part (with the fetch), crop and whole volume
        src = io.read_volume(watch / names[0]).data
        predictors, masks = {}, {}
        for mode, extra, want in (("crop", [], per_batch), ("whole_volume", ["config.whole_volume=true"], 18)):
            predictor = serving.Predictor(compose([*argv, *extra], job_name="serve", make_run_dir=False))
            vol, shape = predictor.prepare(src)
            predictor.predict_prepared(vol, shape)
            prep, times = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vol, shape = predictor.prepare(src)
                torch.cuda.synchronize()
                prep.append(time.perf_counter() - t0)
                before = conv.conv3d_bn_relu.launches
                t0 = time.perf_counter()
                masks[mode] = predictor.predict_prepared(vol, shape)
                times.append(time.perf_counter() - t0)
                check(conv.conv3d_bn_relu.launches - before == want, f"[14] Predictor {mode}: launches")
            predictors[mode] = predictor
            print(f"[14] {card}: warm Predictor, {mode}: predict_prepared (card and int32 fetch) "
                  f"{', '.join(f'{v:.4f}' for v in times)} s a volume, {want} conv3d_bn_relu launches; prepare "
                  f"(z-normalise, pad, upload) {', '.join(f'{v:.4f}' for v in prep)} s", flush=True)
        check(np.array_equal(masks["crop"], io.read_volume(predict_masks[0]).data.astype(np.int32)),
              "[14] the Predictor's crop mask differs from predict.main's")
        del vol

        # the exports through serving.main's export mode, then both artifacts loaded in one process that
        # blocks the port's models and nn packages (and JAX), which reports its own launch counts
        artifacts = {}
        for mode, extra in (("crop", []), ("whole_volume", ["config.whole_volume=true"])):
            artifacts[mode] = work / f"{mode}.pt2"
            zero_counters()
            t0 = time.perf_counter()
            serving.main([*argv, *extra, f"config.export_path={artifacts[mode]}", "config.export_spatial="
                          + ", ".join(map(str, VOLUME))])
            dt = time.perf_counter() - t0
            check(not any(read_counters().values()), f"[14] the {mode} export launched a kernel")
            print(f"[14] {card}: export of the {mode} program at {VOLUME} through serving.main: {dt:.1f} s "
                  f"(model build and weights included), artifact {artifacts[mode].stat().st_size:,} bytes", flush=True)
        torch.save(checkpoint.load_checkpoint(ckpt)["params"], work / "params.pt")
        np.save(work / "volume.npy", transforms.ZNormalization().normalize_array(src))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _BLOCKED_LOAD, str(ROOT), str(work / "params.pt"), str(work / "volume.npy"),
             *(v for mode, path in artifacts.items() for v in (str(path), str(work / f"{mode}.npy")))],
            capture_output=True, text=True, timeout=600,
        )
        check(proc.returncode == 0, f"[14] the artifacts' process failed: {proc.stderr[-3000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        for mode, path in artifacts.items():
            r, want = result[str(path)], per_batch if mode == "crop" else 18
            check(r["launches"] == [want] * 3, f"[14] the {mode} artifact launched {r['launches']}, not {want}")
            check(np.array_equal(np.load(work / f"{mode}.npy"), masks[mode]),
                  f"[14] the {mode} artifact's mask differs from the Predictor's")
            print(f"[14] {card}: the {mode} artifact in a process without the port's models and nn: load "
                  f"{r['load_s']:.1f} s, {', '.join(f'{v:.4f}' for v in r['s'])} s a volume (host z-normalised "
                  f"volume in, int32 mask out), conv3d_bn_relu launches {r['launches']} (its own count), mask "
                  f"equal to the Predictor's", flush=True)
        print(f"[14] the artifacts' process took {time.perf_counter() - t0:.1f} s", flush=True)
        del predictors, masks

        # UNet2D: a Predictor from [10]'s checkpoint gives [10]'s mask
        _, ckpt2d, one2d, mask2d, batches2d = unet2d_run
        predictor = serving.Predictor(compose(["config=unet2d", f"config.ckpt={ckpt2d}", f"config.batch_size={BATCH}",
                                               f"config.output_dir={work / 'serve2d'}"], job_name="serve",
                                              make_run_dir=False))
        zero_counters()
        mask = predictor.predict_file(one2d / "source" / "vol-00.nii.gz")
        got = read_counters()
        check(got["conv2d_bn_relu"] == 18 * batches2d and got["conv3d_bn_relu"] == 0,
              f"[14] UNet2D Predictor launches {got}, not {18 * batches2d}")
        check(np.array_equal(mask.astype(np.float32), io.read_volume(mask2d).data), "[14] UNet2D: not [10]'s mask")
        print(f"[14] UNet2D Predictor from [10]'s checkpoint: [10]'s mask, conv2d_bn_relu launches "
              f"{got['conv2d_bn_relu']}", flush=True)

        # the registered operator against the direct call: host time per call, and UNet2D's sliding window
        def through_operator(x, w, b, relu=True):
            conv._check(x, w, b, x.dim() - 2)
            return conv._REGISTERED[x.dim() - 2](x, w, b, relu)

        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
        x = torch.randn((1, 4, 4, 4, 32), device="cuda", generator=gen, dtype=torch.bfloat16)
        w = torch.randn((3, 3, 3, 32, 32), device="cuda", generator=gen, dtype=torch.bfloat16) * 0.05
        b = torch.randn(32, device="cuda", generator=gen)
        host = {"operator": [], "direct": []}
        for variant in ("operator", "direct", "direct", "operator"):
            fn = through_operator if variant == "operator" else conv.conv3d_bn_relu
            host[variant].append(wrapper_and_host(torch, lambda: fn(x, w, b), calls=500)[1])
        vol2d, _ = predictor.prepare(io.read_volume(one2d / "source" / "vol-00.nii.gz").data)
        patch2d = tuple(predictor.config.patch_size)
        window = {"operator": [], "direct": []}
        sw.sliding_window_predict(predictor.forward, vol2d, patch2d, predictor.overlap, BATCH)
        for pair in range(10):  # alternated pairs, each side first in turn
            for variant in (("operator", "direct") if pair % 2 == 0 else ("direct", "operator")):
                blocks.conv2d_bn_relu = through_operator if variant == "operator" else direct2d
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sw.sliding_window_predict(predictor.forward, vol2d, patch2d, predictor.overlap, BATCH)
                torch.cuda.synchronize()
                window[variant].append(time.perf_counter() - t0)
        blocks.conv2d_bn_relu = direct2d
        wins = sum(o > d for o, d in zip(window["operator"], window["direct"]))
        print(f"[14] {card}: eval conv through the registered operator vs called directly (eager predict calls it "
              f"directly): host us per call at 1x4^3x32 bf16 (500 calls, alternated) operator "
              f"{', '.join(f'{v:.1f}' for v in host['operator'])}, direct {', '.join(f'{v:.1f}' for v in host['direct'])}; "
              f"UNet2D sliding window on the card ({18 * batches2d} convs a volume), 10 alternated pairs: operator "
              f"{', '.join(f'{v:.4f}' for v in window['operator'])} s (median {np.median(window['operator']):.4f}), "
              f"direct {', '.join(f'{v:.4f}' for v in window['direct'])} s (median "
              f"{np.median(window['direct']):.4f}); the direct call faster in {wins} of 10 pairs", flush=True)
        print(f"[14] took {time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        serving.read_volume, serving.write_volume, serving.Predictor.predict_array = read, write, predict_array
        blocks.conv2d_bn_relu = direct2d
        shutil.rmtree(work, ignore_errors=True)


def new_shapes(torch, dev, tag, new, seen, nd, errs):
    """The k3 s1 p1 conv shapes ``new`` ((Cin, Cout, spatial extent) of a
    3-D or, with ``nd`` = 2, a 2-D conv, batch 16) that a phase's networks
    bring and UNet3D's or UNet2D's do not, each in bf16 against its plain
    version with [2]'s and [6]'s limits: forward, input gradient (not for a
    1-channel stem, whose input is data) and weight gradient, with the
    kernel, plain, cuDNN and bound times; the sums printed and each
    direction's largest error folded into ``errs``."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu as conv
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_wgrad as wgrad_op

    d = f"conv{nd}d"
    kernel, plain = getattr(conv, f"{d}_bn_relu"), getattr(conv, f"{d}_bn_relu_reference")
    dgrad, dgrad_plain = getattr(conv, f"{d}_input_grad"), getattr(conv, f"{d}_input_grad_reference")
    wgrad, wgrad_plain = getattr(wgrad_op, f"{d}_wgrad"), getattr(wgrad_op, f"{d}_wgrad_reference")
    library = getattr(torch.nn.functional, d)
    library_input, library_weight = getattr(torch.nn.grad, f"{d}_input"), getattr(torch.nn.grad, f"{d}_weight")
    gen = torch.Generator(device=dev).manual_seed(SEED + (16 if nd == 3 else 20))
    sums = np.zeros((3, 4))
    for cin, cout, s in new:
        x = torch.randn(BATCH, *(s,) * nd, cin, device=dev, generator=gen).bfloat16()
        g = torch.randn(BATCH, *(s,) * nd, cout, device=dev, generator=gen).bfloat16()
        w = (torch.randn(*(3,) * nd, cin, cout, device=dev, generator=gen) * (3**nd * cin) ** -0.5).bfloat16()
        b = 0.1 * torch.randn(cout, device=dev, generator=gen)
        xc, gc, wc = x.movedim(-1, 1), g.movedim(-1, 1), w.permute(nd + 1, nd, *range(nd)).contiguous()
        flops, nbytes = conv_work(BATCH * s**nd, cin, cout, 2, taps=3**nd)
        bound = bound_ms(flops, nbytes, "bfloat16")[0]
        line = f"{tag} conv {cin:>4d}->{cout:<4d} {BATCH}x{s}^{nd} bf16"
        check(x.numel() < INT32_ELEMENTS and g.numel() < INT32_ELEMENTS,  # [13]'s slab rule: none needs slabs
              f"{tag} conv {cin}->{cout} at {s}^{nd}: {max(x.numel(), g.numel())} elements, past 2^31")
        y = kernel(x, w, b, relu=False)
        torch.cuda.synchronize()
        want = plain(x.float(), w.float(), b, relu=False)
        err, lim = (y.float() - want).abs().max().item(), BF16_TOL * max(1.0, want.abs().max().item())
        check(err <= lim, f"{tag} conv {cin}->{cout} at {s}^{nd}: forward error {err} > {lim}")
        errs["fwd"] = max(errs["fwd"], err)
        t = (cuda_ms(torch, lambda: kernel(x, w, b, relu=False), 5),
             cuda_ms(torch, lambda: plain(x, w, b, relu=False), 5),
             cuda_ms(torch, lambda: library(xc, wc, b.bfloat16(), padding=1), 5), bound)
        sums[0] += t
        line += f" | fwd err {err:.3g} (limit {lim:.3g}) kernel {t[0]:.3f} plain {t[1]:.3f} cudnn {t[2]:.3f} bound {t[3]:.4f}"
        del y, want
        if cin > 1:  # a 1-channel stem's input is data: its input gradient is never taken
            dx = dgrad(g, w)
            torch.cuda.synchronize()
            want = library_input((BATCH, cin, *(s,) * nd), w.float().permute(nd + 1, nd, *range(nd)),
                                 g.float().movedim(-1, 1), padding=1).movedim(1, -1)
            err, lim = (dx.float() - want).abs().max().item(), BF16_TOL * max(1.0, want.abs().max().item())
            check(err <= lim, f"{tag} conv {cin}->{cout} at {s}^{nd}: input gradient error {err} > {lim}")
            errs["dgrad"] = max(errs["dgrad"], err)
            t = (cuda_ms(torch, lambda: dgrad(g, w), 5), cuda_ms(torch, lambda: dgrad_plain(g, w), 5),
                 cuda_ms(torch, lambda: library_input((BATCH, cin, *(s,) * nd), wc, gc, padding=1), 5), bound)
            sums[1] += t
            line += f" | dgrad err {err:.3g} (limit {lim:.3g}) kernel {t[0]:.3f} plain {t[1]:.3f} cudnn {t[2]:.3f}"
            del dx, want
        dw = wgrad(x, g)
        torch.cuda.synchronize()
        want = wgrad_plain(x.double(), g.double())
        err, lim = (dw.double() - want).abs().max().item(), WGRAD_TOL * max(1.0, want.abs().max().item())
        check(err <= lim, f"{tag} conv {cin}->{cout} at {s}^{nd}: weight gradient error {err} > {lim}")
        errs["wgrad"] = max(errs["wgrad"], err)
        t = (cuda_ms(torch, lambda: wgrad(x, g), 5), cuda_ms(torch, lambda: wgrad_plain(x, g), 5),
             cuda_ms(torch, lambda: library_weight(xc, (cout, cin, *(3,) * nd), gc, padding=1), 5), bound)
        sums[2] += t
        line += f" | wgrad err {err:.3g} (limit {lim:.3g}) kernel {t[0]:.3f} plain {t[1]:.3f} cudnn {t[2]:.3f} (ms)"
        print(line, flush=True)
        del x, g, w, dw, want, xc, gc, wc
        torch.cuda.empty_cache()
    known = "UNet3D's 18" if nd == 3 else "UNet2D's 18"
    print(f"{tag} {len(new)} conv shapes the networks add to {known} (of {seen}): sums kernel / plain / cudnn / "
          f"bound ms: forward {' / '.join(f'{v:.3f}' for v in sums[0])}, input gradient "
          f"{' / '.join(f'{v:.3f}' for v in sums[1])}, weight gradient {' / '.join(f'{v:.3f}' for v in sums[2])}",
          flush=True)


def zoo_state_dict(torch, model, seed):
    """Seeded weights for any zoo network: fan-in scaled kernels (std
    sqrt(1 / fan_in)), BatchNorm scales in [0.5, 1.5] and variances in
    [0.5, 2], biases, shifts and means N(0, 0.1), PReLU slopes 0.25."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, shape)
        elif name.endswith("alpha"):
            v = np.full(shape, 0.25)
        elif name.endswith("weight") and len(shape) == 1:
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:  # conv, up-conv and Dense kernels [..., Cin, Cout]; UNet3D's Linear head [Cout, Cin]
            fan_in = shape[1] if name.endswith("head.weight") and len(shape) == 2 else np.prod(shape[:-1])
            v = rng.normal(0.0, math.sqrt(1.0 / fan_in), shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        sd[name] = torch.from_numpy(v.astype(np.float32))
    return sd


def config_patch_step(torch, dev, card, network, train):
    """[15]: one warm train step of ``network`` at its shipped config
    (``config=<network>``: 128^3 patches, bf16, Adam) on random device
    batches, at the largest batch of ``CONFIG_BATCHES`` whose step fits on
    the card (a batch that runs out of memory is freed and the next tried):
    the batch, the mean of two warm steps by CUDA events and the peak
    memory."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models import make_forward

    cfg = compose([f"config={network}", "config.precision=bfloat16", "config.optimizer=adam"], job_name="train",
                  make_run_dir=False)
    patch = tuple(int(s) for s in cfg.patch_size)
    model = train.build_model(cfg).to(dev).train()
    step = train.make_train_step(make_forward(cfg, model), train.make_optimizer(cfg, model.parameters()),
                                 train.make_loss_and_metric(cfg))
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    refused = []
    for batch in CONFIG_BATCHES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            xb = torch.randn(batch, *patch, 1, device=dev, generator=gen)
            yb = (torch.rand(batch, *patch, 1, device=dev, generator=gen) > 0.7).float()
            loss, _ = step(xb, yb)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(2):
                loss, _ = step(xb, yb)
            end.record()
            end.synchronize()
        except torch.cuda.OutOfMemoryError:
            refused.append(batch)
            xb = yb = None
            for p in model.parameters():
                p.grad = None
            continue
        check(math.isfinite(loss.item()), f"[15] {network} at {patch}: loss {loss.item()}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[15] {card}: {network} at its config's patch {'x'.join(map(str, patch))} (bf16, Adam): batch "
              f"{batch} (out of memory at {refused or 'none larger'}), warm step {start.elapsed_time(end) / 2:.3f} "
              f"ms, peak memory {peak:.3f} GiB, loss {loss.item():.5f}", flush=True)
        break
    else:
        check(False, f"[15] {network} at {patch}: no batch of {CONFIG_BATCHES} fits")
    del model, step, xb, yb
    torch.cuda.empty_cache()


def zoo_phase(torch, dev, card, zero_counters, read_counters, data):
    """Phase [15]: the 3-D zoo at full width (see the module docstring).
    Returns the largest bf16 error of each conv kernel at the zoo's new
    shapes: {"fwd": e, "dgrad": e, "wgrad": e}."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch import checkpoint, predict, serving, train
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict, compose
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io, transforms
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models import make_forward, pad_multiple
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.registry import model_class
    from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import TorchConv
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu as conv
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import sliding_window as sw

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build"))
    errs = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    try:
        small = work / "small"
        write_volumes(small, io, ZOO_VOLUME, 1)
        tiles = len(sw.grid_locations(ZOO_VOLUME, (PATCH,) * 3, OVERLAP))
        batches = -(-tiles // BATCH)
        steps = N_VOLUMES * ZOO_SAMPLES // BATCH
        shapes = set()  # (Cin, Cout, spatial extent) of the k3 s1 p1 convs at 64^3 patches
        rows = {}
        for network, (fwd, dgrad, wgrad, evals) in ZOO.items():
            # -- train.main at full width, bf16, batch 16 x 64^3, Adam, device data
            t0 = time.perf_counter()
            train_argv = [
                f"config={network}", f"config.data_path={data / 'source'}", f"config.gt_path={data / 'label'}",
                f"config.output_dir={work / network}", f"config.patch_size={PATCH}, {PATCH}, {PATCH}",
                f"config.batch_size={BATCH}", f"config.samples_per_volume={ZOO_SAMPLES}", "config.epochs=1",
                "config.epochs_per_checkpoint=1000", "config.precision=bfloat16", "config.data_backend=device",
                "config.optimizer=adam",
            ]
            torch.cuda.reset_peak_memory_stats()
            zero_counters()
            out = train.main(train_argv)
            torch.cuda.synchronize()
            got = read_counters()
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = {"conv3d_bn_relu": fwd * steps, "conv3d_input_grad": dgrad * steps, "conv3d_wgrad": wgrad * steps,
                    "bce_dice_sums": steps, "bce_dice_grads": steps,
                    "conv2d_bn_relu": 0, "conv2d_input_grad": 0, "conv2d_wgrad": 0}
            check(got == want, f"[15] {network} train launches {got} != {want}")
            (run,) = (work / network).glob("train-*/*")
            losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
                      if line.startswith("Loss: ")]
            check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"[15] {network} losses {losses}")
            train_s = time.perf_counter() - t0

            # warm steps of the entry point's train step on device batches, by CUDA events
            net, opt = out["model"], out["optimizer"]
            cfg = compose(train_argv, job_name="train", make_run_dir=False)
            step = train.make_train_step(make_forward(cfg, net), opt, train.make_loss_and_metric(cfg))
            gen = torch.Generator(device=dev).manual_seed(SEED + 15)
            xb = torch.randn(BATCH, PATCH, PATCH, PATCH, 1, device=dev, generator=gen)
            yb = (torch.rand(BATCH, PATCH, PATCH, PATCH, 1, device=dev, generator=gen) > 0.7).float()
            step(xb, yb)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(2):
                step(xb, yb)
            end.record()
            end.synchronize()
            step_ms = start.elapsed_time(end) / 2

            # the k3 s1 p1 convs' shapes at 64^3 patches, by hooks on one train-mode forward of one sample
            def record(module, args):
                if module.hand_kernel:
                    shapes.add((args[0].shape[-1], module.weight.shape[-1], args[0].shape[1]))

            hooks = [m.register_forward_pre_hook(record) for m in net.modules() if isinstance(m, TorchConv)]
            with torch.no_grad():
                make_forward(cfg, net)(xb[:1])
            for h in hooks:
                h.remove()
            del net, opt, out, step, xb, yb
            torch.cuda.empty_cache()

            # -- predict.main from that checkpoint on one 128x128x64 volume
            pred_argv = [
                f"config={network}", f"config.pred_data_path={small / 'source'}", f"config.pred_gt_path={small / 'label'}",
                f"config.output_dir={work / network / 'pred'}", f"config.ckpt={run / 'latest_checkpoint.ckpt'}",
                f"config.patch_size={PATCH}, {PATCH}, {PATCH}", "config.patch_overlap=" + ", ".join(map(str, OVERLAP)),
                f"config.batch_size={BATCH}", "config.precision=bfloat16",
            ]
            zero_counters()
            t0 = time.perf_counter()
            predict.main(pred_argv)
            torch.cuda.synchronize()
            e2e = time.perf_counter() - t0
            got = read_counters()
            check(got["conv3d_bn_relu"] == evals * batches and not any(v for k, v in got.items() if k != "conv3d_bn_relu"),
                  f"[15] {network} predict launches {got}, not {evals} x {batches} batches")
            (mask_file,) = (work / network / "pred").glob("predict-*/*/pred_file/pred-*.nii.gz")
            mask = io.read_volume(mask_file).data
            check(mask.shape == (1, *ZOO_VOLUME) and set(np.unique(mask).tolist()) <= {0.0, 1.0},
                  f"[15] {network} mask {mask.shape}")
            # the device part alone: the sliding window on the uploaded volume, warm
            pcfg = compose(pred_argv, job_name="predict", make_run_dir=False)
            model = train.build_model(pcfg)
            n_params = sum(p.numel() for p in model.parameters())
            model.load_state_dict(checkpoint.load_checkpoint(run / "latest_checkpoint.ckpt")["params"])
            model.to(dev).eval()
            src = transforms.ZNormalization().normalize_array(io.read_volume(small / "source" / "vol-00.nii.gz").data)
            vol = sw.prepare_volume(src, dev, torch.bfloat16)
            forward = predict.make_forward_fn(pcfg, model)
            with torch.inference_mode():
                sw.sliding_window_predict(forward, vol, (PATCH,) * 3, OVERLAP, BATCH)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sw.sliding_window_predict(forward, vol, (PATCH,) * 3, OVERLAP, BATCH)
                torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            if network in ("fcn3d", "vtnet"):  # the whole volume (fcn3d's p60 stem makes 374x374x246 x 8 maps)
                big = sw.prepare_volume(transforms.ZNormalization().normalize_array(
                    io.read_volume(data / "source" / "vol-00.nii.gz").data), dev, torch.bfloat16)
                runs = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    zero_counters()
                    t0 = time.perf_counter()
                    with torch.inference_mode():
                        wmask = sw.whole_volume_predict(forward, big, pad_multiple=pad_multiple(network))
                    torch.cuda.synchronize()
                    runs.append(time.perf_counter() - t0)
                    got = read_counters()
                    check(got["conv3d_bn_relu"] == evals and tuple(wmask.shape) == VOLUME,
                          f"[15] {network} whole volume: launches {got}, mask {tuple(wmask.shape)}")
                whole_peak = torch.cuda.max_memory_allocated() / 2**30
                print(f"[15] {card}: {network}'s whole-volume forward over {'x'.join(map(str, VOLUME))} (bf16, batch "
                      f"1): {runs[0]:.4f} s cold, {runs[1]:.4f} s warm, peak memory {whole_peak:.3f} GiB, mask "
                      f"{tuple(wmask.shape)}, {evals} conv3d_bn_relu launches", flush=True)
                del big, wmask
            both = ""
            if network == "IS":  # its eval forward (out1 alone) against one that also runs both bands, alternated
                from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.fft import band_split

                pairs = []
                with torch.inference_mode():
                    for _ in range(4):
                        pair = []
                        for f in (forward, lambda t: model(t, *band_split(t, limit=0.04))[0]):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            sw.sliding_window_predict(f, vol, (PATCH,) * 3, OVERLAP, BATCH)
                            torch.cuda.synchronize()
                            pair.append(time.perf_counter() - t0)
                        pairs.append(pair)
                both = (f"; IS's window with out1 alone / with all three decoders, alternated (the first pair "
                        f"warms the latter): {', '.join(f'{a:.4f} / {b:.4f}' for a, b in pairs)} s")
            del model, vol, forward
            rows[network] = (step_ms, peak, e2e, card_s)
            print(f"[15] {card}: {network} ({n_params:,} parameters): train.main {steps} steps in {train_s:.1f} s, "
                  f"losses {[round(v, 5) for v in losses]}, launches per step {fwd}/{dgrad}/{wgrad} + 1/1 loss; warm "
                  f"step {step_ms:.3f} ms (bf16, {BATCH}x{PATCH}^3), peak memory {peak:.3f} GiB; predict.main on "
                  f"{'x'.join(map(str, ZOO_VOLUME))} ({tiles} tiles, {batches} batches, {evals * batches} conv launches): "
                  f"{e2e:.3f} s end to end, the sliding window on the card {card_s:.4f} s{both}", flush=True)
            if network in TRANSFORMERS:
                config_patch_step(torch, dev, card, network, train)

        # -- each new conv shape against its plain version, bf16 at batch 16
        unet = {(ci, co, PATCH >> lv) for (ci, co), lv in zip(
            [(1, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 512),
             (512, 512), (512, 256), (256, 256), (256, 128), (128, 128), (128, 64), (64, 64), (64, 32), (32, 32)],
            LEVELS)}  # UNet3D's 18, checked in [2] and [6]
        new_shapes(torch, dev, "[15]", sorted(shapes - unet, key=lambda s: (-s[2], s[0], s[1])), len(shapes), 3, errs)

        # -- f32 card against CPU at a narrow width on 32^3
        rng = np.random.default_rng(SEED + 17)
        x32 = torch.from_numpy(rng.normal(size=(1, 32, 32, 32, 1)).astype(np.float32))
        for network, args in ZOO_NARROW.items():
            net = model_class(network)(*args)
            net.load_state_dict(zoo_state_dict(torch, net, SEED + 17))
            forward = make_forward(ConfigDict(network=network), net.eval())
            with torch.inference_mode():
                want = forward(x32)
                got = make_forward(ConfigDict(network=network), net.to(dev))(x32.to(dev)).cpu()
            scale = max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            check(got.shape == want.shape == (1, 32, 32, 32, 2) and torch.isfinite(got).all().item(),
                  f"[15] {network} f32 logits {tuple(got.shape)}")
            check(err <= 1e-3 * scale, f"[15] {network} f32 logits card vs CPU: max|diff| {err} > {1e-3 * scale}")
            print(f"[15] {network} {args} f32 logits on 32^3, card vs CPU: max|diff| {err:.3g} (scale {scale:.3g})",
                  flush=True)
            del net

        # -- the export of a network of bare TorchConvs: ER-Net, whole volume
        net = model_class("er_net")(2, 1)
        state = zoo_state_dict(torch, net, SEED + 18)
        ecfg = compose(["config=er_net", f"config.patch_size={PATCH}, {PATCH}, {PATCH}", "config.whole_volume=true",
                        "config.precision=bfloat16", f"config.output_dir={work / 'serve'}"], job_name="serve")
        predictor = serving.Predictor(ecfg, model=net, params=state)
        raw = io.read_volume(small / "source" / "vol-00.nii.gz").data
        want = predictor.predict_array(raw)
        t0 = time.perf_counter()
        blob = serving.export_predictor(predictor, ZOO_VOLUME)
        export_s = time.perf_counter() - t0
        exported = serving.load_exported_predictor(blob)
        before = conv.conv3d_bn_relu.launches
        got = exported({k: v.to(dev) for k, v in state.items()}, transforms.ZNormalization().normalize_array(raw))
        launched = conv.conv3d_bn_relu.launches - before
        check(got.shape == (1, *ZOO_VOLUME) and np.array_equal(got, want), "[15] the er_net artifact's mask differs")
        check(launched == ZOO["er_net"][3], f"[15] the er_net artifact launched {launched} eval convs, not 14")
        print(f"[15] export of ER-Net's whole-volume program at {'x'.join(map(str, ZOO_VOLUME))}: {export_s:.1f} s, "
              f"{len(blob):,} bytes; loaded, its mask is the Predictor's ({100 * want.mean():.2f}% foreground), "
              f"{launched} conv3d_bn_relu launches", flush=True)
        # -- the export of VT-UNet's crop program: its roll, window partition and shift masks
        net = model_class("vtnet")(2, 1)
        state = zoo_state_dict(torch, net, SEED + 19)
        vcfg = compose(["config=vtnet", f"config.patch_size={PATCH}, {PATCH}, {PATCH}",
                        "config.patch_overlap=" + ", ".join(map(str, OVERLAP)), f"config.batch_size={BATCH}",
                        "config.precision=bfloat16", f"config.output_dir={work / 'serve'}"], job_name="serve")
        predictor = serving.Predictor(vcfg, model=net, params=state)
        want = predictor.predict_array(raw)
        t0 = time.perf_counter()
        blob = serving.export_predictor(predictor, ZOO_VOLUME)
        export_s = time.perf_counter() - t0
        exported = serving.load_exported_predictor(blob)
        zero_counters()
        got = exported({k: v.to(dev) for k, v in state.items()}, transforms.ZNormalization().normalize_array(raw))
        launched = read_counters()
        check(got.shape == (1, *ZOO_VOLUME) and np.array_equal(got, want), "[15] the vtnet artifact's mask differs")
        check(not any(launched.values()), f"[15] the vtnet artifact launched {launched}")
        print(f"[15] export of VT-UNet's crop program at {'x'.join(map(str, ZOO_VOLUME))} ({PATCH}^3 tiles, batch "
              f"{BATCH}): {export_s:.1f} s, {len(blob):,} bytes; loaded, its mask is the Predictor's "
              f"({100 * want.mean():.2f}% foreground), no conv launch", flush=True)
        del net, predictor, exported
        print(f"[15] {card}: the zoo's warm step ms / peak GiB / predict s end to end / s on the card: "
              + "; ".join(f"{n} {r[0]:.1f} / {r[1]:.2f} / {r[2]:.2f} / {r[3]:.4f}" for n, r in rows.items())
              + f"; [15] took {time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return errs


def zoo2d_phase(torch, dev, card, zero_counters, read_counters, data):
    """Phase [16]: the 2-D zoo at full width (see the module docstring).
    Returns the largest bf16 error of each 2-D conv kernel at the new
    shapes: {"fwd": e, "dgrad": e, "wgrad": e}."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch import checkpoint, predict, train
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict, compose
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io, transforms
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models import make_forward
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.registry import model_class
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.two_d.unet2d import UNet2D
    from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import TorchConv
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import sliding_window as sw

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build"))
    errs = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    patch, overlap = (1, SLICE, SLICE), (0, 4, 36)  # OVERLAP clamped below the patch, as predict does
    try:
        small = work / "small"
        write_volumes(small, io, ZOO2D_VOLUME, 1)
        tiles = len(sw.grid_locations(ZOO2D_VOLUME, patch, overlap))
        batches = -(-tiles // BATCH)
        steps = N_VOLUMES * ZOO_SAMPLES // BATCH
        shapes = set()  # (Cin, Cout, H) of the k3 s1 p1 convs at 128^2 slices
        rows = {}
        for network, (fwd, dgrad, wgrad, evals) in ZOO2D.items():
            # -- train.main at full width, bf16, batch 16 x 1 x 128^2, Adam, device data
            t0 = time.perf_counter()
            train_argv = [
                f"config={network}", f"config.data_path={data / 'source'}", f"config.gt_path={data / 'label'}",
                f"config.output_dir={work / network}", f"config.patch_size=1, {SLICE}, {SLICE}",
                f"config.batch_size={BATCH}", f"config.samples_per_volume={ZOO_SAMPLES}", "config.epochs=1",
                "config.epochs_per_checkpoint=1000", "config.precision=bfloat16", "config.data_backend=device",
                "config.optimizer=adam",
            ]
            torch.cuda.reset_peak_memory_stats()
            zero_counters()
            out = train.main(train_argv)
            torch.cuda.synchronize()
            got = read_counters()
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = {"conv2d_bn_relu": fwd * steps, "conv2d_input_grad": dgrad * steps, "conv2d_wgrad": wgrad * steps,
                    "bce_dice_sums": steps, "bce_dice_grads": steps,
                    "conv3d_bn_relu": 0, "conv3d_input_grad": 0, "conv3d_wgrad": 0}
            check(got == want, f"[16] {network} train launches {got} != {want}")
            (run,) = (work / network).glob("train-*/*")
            losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
                      if line.startswith("Loss: ")]
            check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"[16] {network} losses {losses}")
            train_s = time.perf_counter() - t0

            # warm steps of the entry point's train step (through the 2-D slice adapter), by CUDA events
            net, opt = out["model"], out["optimizer"]
            cfg = compose(train_argv, job_name="train", make_run_dir=False)
            step = train.make_train_step(make_forward(cfg, net), opt, train.make_loss_and_metric(cfg))
            gen = torch.Generator(device=dev).manual_seed(SEED + 21)
            xb = torch.randn(BATCH, *patch, 1, device=dev, generator=gen)
            yb = (torch.rand(BATCH, *patch, 1, device=dev, generator=gen) > 0.7).float()
            step(xb, yb)
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(2):
                step(xb, yb)
            end.record()
            end.synchronize()
            step_ms = start.elapsed_time(end) / 2
            step_peak = torch.cuda.max_memory_allocated() / 2**30

            def record(module, args):
                if module.hand_kernel:
                    shapes.add((args[0].shape[-1], module.weight.shape[-1], args[0].shape[1]))

            hooks = [m.register_forward_pre_hook(record) for m in net.modules() if isinstance(m, TorchConv)]
            with torch.no_grad():
                make_forward(cfg, net)(xb[:1])
            for h in hooks:
                h.remove()
            n_params = sum(p.numel() for p in net.parameters())
            del net, opt, out, step, xb, yb
            torch.cuda.empty_cache()

            # -- predict.main from that checkpoint on one volume of 64 slices of 128^2
            pred_argv = [
                f"config={network}", f"config.pred_data_path={small / 'source'}", f"config.pred_gt_path={small / 'label'}",
                f"config.output_dir={work / network / 'pred'}", f"config.ckpt={run / 'latest_checkpoint.ckpt'}",
                f"config.batch_size={BATCH}", "config.precision=bfloat16",
            ]
            zero_counters()
            t0 = time.perf_counter()
            predict.main(pred_argv)
            torch.cuda.synchronize()
            e2e = time.perf_counter() - t0
            got = read_counters()
            check(got["conv2d_bn_relu"] == evals * batches and not any(v for k, v in got.items() if k != "conv2d_bn_relu"),
                  f"[16] {network} predict launches {got}, not {evals} x {batches} batches")
            (mask_file,) = (work / network / "pred").glob("predict-*/*/pred_file/pred-*.nii.gz")
            mask = io.read_volume(mask_file).data
            check(mask.shape == (1, *ZOO2D_VOLUME) and set(np.unique(mask).tolist()) <= {0.0, 1.0},
                  f"[16] {network} mask {mask.shape}")
            pcfg = compose(pred_argv, job_name="predict", make_run_dir=False)
            model = train.build_model(pcfg)
            model.load_state_dict(checkpoint.load_checkpoint(run / "latest_checkpoint.ckpt")["params"])
            model.to(dev).eval()
            src = transforms.ZNormalization().normalize_array(io.read_volume(small / "source" / "vol-00.nii.gz").data)
            vol = sw.prepare_volume(src, dev, torch.bfloat16)
            forward = predict.make_forward_fn(pcfg, model)
            with torch.inference_mode():
                sw.sliding_window_predict(forward, vol, patch, overlap, BATCH)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sw.sliding_window_predict(forward, vol, patch, overlap, BATCH)
                torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            del model, vol, forward
            rows[network] = (step_ms, peak, step_peak, e2e, card_s)
            print(f"[16] {card}: {network} ({n_params:,} parameters): train.main {steps} steps in {train_s:.1f} s, "
                  f"losses {[round(v, 5) for v in losses]}, launches per step {fwd}/{dgrad}/{wgrad} (conv2d) + 1/1 "
                  f"loss, no conv3d; warm step {step_ms:.3f} ms (bf16, {BATCH}x1x{SLICE}^2), peak memory {peak:.3f} GiB "
                  f"(train.main), {step_peak:.3f} GiB (warm steps); predict.main on {'x'.join(map(str, ZOO2D_VOLUME))} "
                  f"({tiles} slices, {batches} batches, {evals * batches} conv launches): {e2e:.3f} s end to end, "
                  f"the sliding window on the card {card_s:.4f} s", flush=True)

        # -- each new 2-D conv shape against its plain version, bf16 at batch 16
        unet2d = {(ci, co, SLICE >> lv) for (ci, co), lv in zip(
            [tuple(block.conv.weight.shape[2:]) for block in UNet2D(1, 2).blocks], LEVELS)}  # [9]'s 18
        new_shapes(torch, dev, "[16]", sorted(shapes - unet2d, key=lambda s: (-s[2], s[0], s[1])), len(shapes), 2,
                   errs)

        # -- f32 card against CPU on a batch of 2 x 1 x 64^2
        rng = np.random.default_rng(SEED + 22)
        x64 = torch.from_numpy(rng.normal(size=(2, 1, 64, 64, 1)).astype(np.float32))
        for network in ZOO2D:
            net = model_class(network)(1, 2)
            net.load_state_dict(zoo_state_dict(torch, net, SEED + 22))
            forward = make_forward(ConfigDict(network=network), net.eval())
            with torch.inference_mode():
                want = forward(x64)
                got = make_forward(ConfigDict(network=network), net.to(dev))(x64.to(dev)).cpu()
            scale = max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            check(got.shape == want.shape == (2, 1, 64, 64, 2) and torch.isfinite(got).all().item(),
                  f"[16] {network} f32 logits {tuple(got.shape)}")
            check(err <= 1e-3 * scale, f"[16] {network} f32 logits card vs CPU: max|diff| {err} > {1e-3 * scale}")
            print(f"[16] {network} f32 logits on 2x1x64^2, card vs CPU: max|diff| {err:.3g} (scale {scale:.3g})",
                  flush=True)
            del net
        print(f"[16] {card}: the 2-D zoo's warm step ms / peak GiB (train.main) / predict s end to end / s on the "
              "card: " + "; ".join(f"{n} {r[0]:.1f} / {r[1]:.2f} / {r[3]:.2f} / {r[4]:.4f}" for n, r in rows.items())
              + f"; [16] took {time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return errs


def hand_kernel_counts(per_call):
    """{kind: launches} of the hand-written kernels in ``profiled_ms``'s
    {kernel name: launches per call}: "conv KD=k" (``conv_wgmma``,
    ``conv3d_bn_relu_bf16`` / ``_f32``: the forward and the input gradient),
    "wgrad KD=k" (``wgrad_gather``, ``wgrad_slab``, ``wgrad_stem``,
    ``wgrad_fma``), ``bce_dice_forward``, ``bce_dice_backward``; k is the
    kernel's first template argument, its depth taps (3 in 3-D, 1 in 2-D)."""
    counts = {}
    for key, n in per_call.items():
        name = key.replace("void ", "").replace("(anonymous namespace)::", "")
        base = name.split("<")[0].split("(")[0]
        taps = name.split("<", 1)[1].split(",")[0].split(">")[0] if "<" in name else ""
        if base in ("conv_wgmma", "conv3d_bn_relu_bf16", "conv3d_bn_relu_f32"):
            kind = f"conv KD={taps}"
        elif base in ("wgrad_gather", "wgrad_slab", "wgrad_stem", "wgrad_fma"):
            kind = f"wgrad KD={taps}"
        elif base in ("bce_dice_forward", "bce_dice_backward"):
            kind = base
        else:
            continue
        counts[kind] = counts.get(kind, 0) + n
    return counts


KIND = {"conv3d_bn_relu": "conv KD=3", "conv3d_input_grad": "conv KD=3", "conv3d_wgrad": "wgrad KD=3",
        "conv2d_bn_relu": "conv KD=1", "conv2d_input_grad": "conv KD=1", "conv2d_wgrad": "wgrad KD=1",
        "bce_dice_sums": "bce_dice_forward", "bce_dice_grads": "bce_dice_backward"}


def replayed_launches(torch, scan, eager, note):
    """({wrapper: launches} that ``scan``'s graph made in its replays, one
    replay's hand kernels by name). ``eager`` is the run's wrapper counts,
    which hold only its eager steps (``scan.eager_steps``: step 0 of each
    epoch that captured the graph); one replay of the run's own graph,
    profiled at step 0, must launch by name what one of those steps
    launched; each replay then counts as one eager step's launches."""
    per_step = {k: v // scan.eager_steps for k, v in eager.items()}
    check(scan.eager_steps > 0 and all(v == per_step[k] * scan.eager_steps for k, v in eager.items()),
          f"[17] {note}: {eager} over {scan.eager_steps} eager steps")
    want = {}
    for k, v in per_step.items():
        if v:
            want[KIND[k]] = want.get(KIND[k], 0) + v

    def step_0():  # the plan's step 0 again: any number of calls stays inside the plan
        scan.counter.zero_()
        scan.graph.replay()

    # 10 calls: the profiler may miss the first events of its window, and profiled_ms rounds
    replay = hand_kernel_counts(profiled_ms(torch, step_0, calls=10)[1])
    check(replay == want, f"[17] {note}: one replay's hand kernels {replay}, one eager step's {want}")
    return {k: v * scan.replays for k, v in per_step.items()}, replay


def nondeterministic_ops(torch, fn):
    """The operations that torch flags as not run-to-run reproducible on
    the card in one call of ``fn``, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    found = set()
    for w in caught:
        msg = str(w.message)
        if " does not have a deterministic implementation" in msg:
            found.add(msg.split(" does not have a deterministic implementation")[0])
        elif "CuBLAS" in msg:
            found.add("cuBLAS")
    return sorted(found)


def upsample_backward_spread(torch, dev):
    """Max |difference| between two runs of the backward of UNet2D's decoder
    upsampling (``nn.blocks.resize_linear_align_corners``: bilinear,
    align_corners) on the same inputs and cotangents, at its four shapes
    (16 x 8^2 x 512 to 16 x 64^2 x 64, doubled), bf16: 0 where it is
    reproducible."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import resize_linear_align_corners

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    spread = []
    for side, ch in ((8, 512), (16, 256), (32, 128), (64, 64)):
        x = torch.randn(BATCH, side, side, ch, device=dev, generator=gen).bfloat16().requires_grad_()
        g = torch.randn(BATCH, 2 * side, 2 * side, ch, device=dev, generator=gen).bfloat16()
        dx = [torch.autograd.grad(resize_linear_align_corners(x, (2 * side, 2 * side)), x, g)[0].float()
              for _ in range(2)]
        spread.append((dx[0] - dx[1]).abs().max().item())
    return spread


def graph_against_eager(torch, dev, cfg, steps, tag):
    """[17]'s epoch graph against the eager loop of the same step, at full
    width on ``cfg``'s volumes: three copies of the model (the seeded init),
    three ``EpochScan``s on the stacked store: the graph's and two eager
    loops', whose distance is the eager step's own run-to-run spread. Three
    epochs of ``steps`` steps of the same plans. Returns a dict: "losses"
    of the first epoch (graph, eager, eager again; the graph's step 0 runs
    eagerly, its step 1 is the first replay), "distance" and "spread", the
    weights' relative L2 distance after that epoch, graph against eager and
    eager against eager again; "sgd_spread", the latter with SGD (momentum
    0.9) in place of Adam; "ms" {"graph": [...], "eager": [...]} per
    step over the next two epochs in turns (graph, eager, eager, graph);
    "replay" and "eager_step", the hand kernels of one replay and of one
    eager step by name; "nondeterministic", the operations torch flags in
    one eager step."""
    import copy

    from general_medical_image_segmentation_cnn_framework_tpu_torch import models, optim, train
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import make_dataset
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.epoch_scan import (
        build_epoch_plan, make_epoch_scan, stack_store,
    )

    dataset = make_dataset(cfg, is_train=True, device=dev)
    volumes = stack_store([v[0] for v in dataset.volumes])
    labels = stack_store([v[1] for v in dataset.volumes])
    shapes = np.asarray([v[0].shape[:3] for v in dataset.volumes])
    del dataset
    nets = [models.build_model(cfg).to(dev).train()]
    nets += [copy.deepcopy(nets[0]) for _ in range(2)]
    scans = []
    for net in nets:
        opt = optim.make_optimizer(cfg, net.parameters())
        step = train.make_train_step(models.make_forward(cfg, net), opt, train.make_loss_and_metric(cfg))
        scans.append(make_epoch_scan(cfg, net, opt, step, volumes, labels))
    graph, eager, again = scans
    rng = np.random.default_rng(SEED + 17)
    plans = [build_epoch_plan(len(shapes), steps * BATCH // len(shapes), BATCH, shapes, cfg.patch_size, rng)
             for _ in range(3)]
    check(all(len(p[0]) == steps for p in plans), f"[17] {tag} plan of {len(plans[0][0])} steps, not {steps}")

    def run_graph(plan):
        return graph(*plan)[0]

    def run_eager(plan, scan=eager):
        scan.start_epoch(*plan)
        for _ in range(steps):
            scan.step()
        return scan.losses.clone()

    def timed(fn, plan):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        losses = fn(plan)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps, losses

    def weights(net):
        return torch.cat([p.detach().flatten().float() for p in net.parameters()])

    out = {"losses": [run_graph(plans[0]).cpu(), run_eager(plans[0]).cpu(), run_eager(plans[0], again).cpu()]}
    check(graph.graph is not None and (graph.eager_steps, graph.replays) == (1, steps - 1),
          f"[17] {tag}: graph {graph.graph}, {graph.eager_steps} eager steps, {graph.replays} replays")
    for losses in out["losses"]:
        check(torch.isfinite(losses).all().item(), f"[17] {tag} losses {losses.tolist()}")
    w = [weights(net) for net in nets]
    out["distance"] = ((w[0] - w[1]).norm() / w[1].norm()).item()
    out["spread"] = ((w[2] - w[1]).norm() / w[1].norm()).item()
    del w
    sgd_cfg = copy.deepcopy(cfg)
    sgd_cfg.optimizer, sgd_cfg.momentum = "sgd", 0.9
    sgd_nets = [models.build_model(sgd_cfg).to(dev).train()]
    sgd_nets.append(copy.deepcopy(sgd_nets[0]))
    for net in sgd_nets:
        opt = optim.make_optimizer(sgd_cfg, net.parameters())
        step = train.make_train_step(models.make_forward(sgd_cfg, net), opt, train.make_loss_and_metric(sgd_cfg))
        run_eager(plans[0], make_epoch_scan(sgd_cfg, net, opt, step, volumes, labels))
    w = [weights(net) for net in sgd_nets]
    out["sgd_spread"] = ((w[1] - w[0]).norm() / w[0].norm()).item()
    del w, sgd_nets, opt, step
    out["ms"] = {"graph": [], "eager": []}
    for name, plan in (("graph", plans[1]), ("eager", plans[1]), ("eager", plans[2]), ("graph", plans[2])):
        ms, losses = timed(run_graph if name == "graph" else run_eager, plan)
        check(torch.isfinite(losses).all().item(), f"[17] {tag} {name} losses {losses.tolist()}")
        out["ms"][name].append(ms)

    def at_step_0(scan, run):
        def call():  # the plan's step 0 again: any number of calls stays inside the plan
            scan.counter.zero_()
            run()
        return call

    # 10 calls each: the profiler may miss the first events of its window, and profiled_ms rounds
    graph.start_epoch(*plans[0])
    out["replay"] = hand_kernel_counts(profiled_ms(torch, at_step_0(graph, graph.graph.replay), calls=10)[1])
    eager.start_epoch(*plans[0])
    out["eager_step"] = hand_kernel_counts(profiled_ms(torch, at_step_0(eager, eager.step), calls=10)[1])
    again.start_epoch(*plans[0])
    out["nondeterministic"] = nondeterministic_ops(torch, again.step)
    torch.cuda.synchronize()
    del scans, graph, eager, again, nets, volumes, labels
    return out


def data_phase(torch, dev, card, zero_counters, read_counters, add_launches, data):
    """Phase [17]: on-device augmentation, the epoch graph and the worker
    loader at full width (see the module docstring)."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch import checkpoint, models, optim, train
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import device_aug as aug
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data import make_dataset, pipeline, transforms
    from general_medical_image_segmentation_cnn_framework_tpu_torch.data.grain_pipeline import WorkerPatchDataset
    from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import Dropout
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.epoch_scan import (
        build_epoch_plan, make_epoch_scan, stack_store,
    )

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build"))
    pairs = list(zip(sorted((data / "source").glob("*.nii.gz")), sorted((data / "label").glob("*.nii.gz"))))
    per_step = {"conv3d_bn_relu": 18, "conv3d_input_grad": 17, "conv3d_wgrad": 18, "bce_dice_sums": 1,
                "bce_dice_grads": 1, "conv2d_bn_relu": 0, "conv2d_input_grad": 0, "conv2d_wgrad": 0}

    def base_argv(name, *extra):
        return [f"config.data_path={data / 'source'}", f"config.gt_path={data / 'label'}",
                f"config.output_dir={work / name}", f"config.batch_size={BATCH}",
                "config.epochs_per_checkpoint=1000", *extra]

    def unet_argv(name, *extra):
        return ["config=unet", f"config.patch_size={PATCH}, {PATCH}, {PATCH}", *base_argv(name, *extra)]

    def run_train(name, argv, eager_steps, note):
        """train.main(argv), writing under work / name: (its result, the run dir, the logged losses,
        the wall seconds, the wrappers' launch counts, those of an epoch_scan run's replays and one
        replay's hand kernels by name). The wrapper counts are checked against eager_steps of
        per_step (None: not checked); an epoch_scan run's replays count by replayed_launches."""
        zero_counters()
        t0 = time.perf_counter()
        out = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counters()
        if eager_steps is not None:
            want = {k: v * eager_steps for k, v in per_step.items()}
            check(got == want, f"[17] {note} train launches {got} != {want}")
        replayed, replay = {}, None
        if out["scan"] is not None:
            replayed, replay = replayed_launches(torch, out["scan"], got, note)
            add_launches(replayed)
        (run,) = (work / name).glob("train-*/*")
        losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
                  if line.startswith("Loss: ")]
        check(all(math.isfinite(v) for v in losses), f"[17] {note} losses {losses}")
        return out, run, losses, wall, got, replayed, replay

    try:
        # -- 17.1 the augmentation on the card, per volume and by branch; the host stack; card vs CPU
        subjects = [pipeline.load_subject(p) for p in pairs]
        on_card = [(torch.from_numpy(s.source.data).to(dev), torch.from_numpy(s.gt.data).to(dev)) for s in subjects]
        gen = torch.Generator(device=dev).manual_seed(SEED + 17)

        def prefix(src, gt):  # augment_pair up to its OneOf: bias field, z-normalisation, noise, flip
            src = src.float() * aug.polynomial_bias_field(gen, src.shape[1:])[None]
            return aug.random_flip_pair(gen, aug.random_noise(gen, aug.znormalize(src)), gt.float())

        branch_ms = {"affine": [], "elastic": []}
        for pair in on_card:
            prefix_ms = cuda_ms(torch, lambda: prefix(*pair), reps=5)
            flipped = prefix(*pair)
            for branch, fn in (("affine", aug.random_affine_pair), ("elastic", aug.random_elastic_pair)):
                branch_ms[branch].append(prefix_ms + cuda_ms(torch, lambda: fn(gen, *flipped), reps=5))
            del flipped
        s_out, g_out = aug.augment_pair(gen, *on_card[0])
        check(s_out.shape == on_card[0][0].shape and torch.isfinite(s_out).all().item()
              and set(g_out.unique().tolist()) <= {0.0, 1.0}, "[17] augment_pair on the card")
        host_s = {}
        for branch, spatial in (("affine", transforms.RandomAffine()),
                                ("elastic", transforms.RandomElasticDeformation())):
            stack = transforms.Compose([transforms.RandomBiasField(), transforms.ZNormalization(),
                                        transforms.RandomNoise(), transforms.RandomFlip(axes=(0,)), spatial])
            t0 = time.perf_counter()
            stack(subjects[0].copy(), np.random.default_rng(SEED))
            host_s[branch] = time.perf_counter() - t0
        aug_cfg = compose(unet_argv("host", "config.aug=true"), job_name="train", make_run_dir=False)
        t0 = time.perf_counter()
        transforms.build_transform(aug_cfg, True)(subjects[0].copy(), np.random.default_rng(SEED + 1))
        host_s["build_transform"] = time.perf_counter() - t0
        print(f"[17] {card}: augment_pair on the card, 256x256x128, warm, ms per volume (the two volumes; its "
              f"steps up to the OneOf, then one branch, each by CUDA events): affine "
              f"{' / '.join(f'{v:.3f}' for v in branch_ms['affine'])}, elastic "
              f"{' / '.join(f'{v:.3f}' for v in branch_ms['elastic'])}; the host stack on one volume: "
              f"build_transform(aug=true) {host_s['build_transform']:.3f} s, with the affine branch "
              f"{host_s['affine']:.3f} s, with the elastic one {host_s['elastic']:.3f} s", flush=True)
        src, gt = on_card[0]
        center = (np.asarray(src.shape[1:], np.float32) - 1) / 2
        m = aug.affine_matrix(torch.tensor([0.95, 1.05, 1.0]), torch.tensor([8.0, -5.0, 3.0]), torch.zeros(3),
                              torch.from_numpy(center))
        grid = np.zeros((3, 7, 7, 7), np.float32)
        grid[:, 2:5, 2:5, 2:5] = np.random.default_rng(SEED + 17).uniform(-7.5, 7.5, (3, 3, 3, 3))
        for name, fn, arg in (("affine", aug.affine_resample_pair, m),
                              ("elastic", aug.elastic_resample_pair, torch.from_numpy(grid))):
            got_s, got_g = (t.cpu() for t in fn(src, gt, arg.to(dev)))
            want_s, want_g = fn(src.cpu(), gt.cpu(), arg)
            scale = max(1.0, want_s.abs().max().item())
            err = (got_s - want_s).abs().max().item()
            agree = (got_g == want_g).float().mean().item()
            check(err <= 1e-4 * scale, f"[17] {name} resample card vs CPU: max|diff| {err} > {1e-4 * scale}")
            check(agree >= 0.999 and set(got_g.unique().tolist()) <= {0.0, 1.0},
                  f"[17] {name} label card vs CPU: agreement {agree}")
            print(f"[17] {name} resample with fixed parameters, card vs CPU: image max|diff| {err:.3g} (scale "
                  f"{scale:.3g}), labels agree on {100 * agree:.4f}% of the voxels", flush=True)
        del on_card, src, gt, s_out, g_out

        # -- 17.2 per-step training with the augmentation on the card (data_backend=device)
        aug_argv = unet_argv("aug", "config.aug=true", "config.samples_per_volume=16", "config.epochs=2")
        out, run, losses, wall, got, _, _ = run_train("aug", aug_argv, 4, "aug=true")
        check(len(losses) == 4, f"[17] aug=true losses {losses}")
        ds = make_dataset(compose(aug_argv, job_name="train", make_run_dir=False), is_train=True, device=dev)
        epoch_ms = []
        for epoch in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen_e = ds.aug_generator(epoch)
            for i in range(len(ds.volumes)):
                ds.augmented(i, gen_e)
            torch.cuda.synchronize()
            epoch_ms.append(1e3 * (time.perf_counter() - t0))
        print(f"[17] {card}: train.main config=unet aug=true (device backend, 16 x {PATCH}^3 bf16): 2 epochs of 2 "
              f"steps in {wall:.1f} s, launches {got}, losses {[round(v, 5) for v in losses]}; the augmentation of "
              f"an epoch's 2 volumes {' / '.join(f'{v:.1f}' for v in epoch_ms)} ms (host clock, synchronised)",
              flush=True)
        del out, ds

        # -- 17.3 epoch_scan, config=unet: train.main (the schedule reaches the replays), graph against eager
        scan_argv = unet_argv("scan", "config.epoch_scan=true", "config.samples_per_volume=32", "config.epochs=2",
                              "config.epochs_per_checkpoint=1", "config.scheduler_step_size=1",
                              "config.scheduler_gamma=0")
        # Adam's learning rate lives on the device: one capture, after step 0, then 3 + 4 replays
        out, run, losses, wall, got, replayed, replay = run_train("scan", scan_argv, 1, "epoch_scan")
        check(len(losses) == 8, f"[17] epoch_scan losses {losses}")
        check((out["scan"].eager_steps, out["scan"].replays) == (1, 7),
              f"[17] epoch_scan: {out['scan'].eager_steps} eager steps, {out['scan'].replays} replays")
        names = [n for n, _ in out["model"].named_parameters()]
        ckpts = [checkpoint.load_checkpoint(run / f"checkpoint_{e:04d}.ckpt")["params"] for e in (1, 2)]
        frozen = all(torch.equal(ckpts[0][n], ckpts[1][n]) for n in names)
        moved = any(not torch.equal(ckpts[0][n], ckpts[1][n]) for n in ckpts[0] if "running_" in n)
        check(frozen and moved, f"[17] lr 0 in epoch 2: parameters unchanged {frozen}, statistics moved {moved}")
        print(f"[17] train.main config=unet epoch_scan=true: 2 epochs of 4 steps in {wall:.1f} s: step 0 eager, "
              f"launches {got}; 7 replays, one of which launched {replay} by name, launches {replayed}; losses "
              f"{[round(v, 5) for v in losses]}; with lr 0 in epoch 2 every parameter equals epoch 1's bit for bit, "
              f"the BatchNorm statistics moved", flush=True)
        resume_argv = unet_argv("resume", "config.samples_per_volume=32", "config.epochs=3", "config.load_mode=1",
                                f"config.ckpt={run / 'latest_checkpoint.ckpt'}")
        _, _, losses, _, got, _, _ = run_train("resume", resume_argv, 4, "per-step resume of an epoch_scan checkpoint")
        check(len(losses) == 4, f"[17] resume losses {losses}")
        print(f"[17] a per-step train.main resumed the epoch_scan run's checkpoint (capturable Adam) for epoch 3: "
              f"launches {got}, losses {[round(v, 5) for v in losses]}", flush=True)
        del out, ckpts

        want_3d = {"conv KD=3": 35, "wgrad KD=3": 18, "bce_dice_forward": 1, "bce_dice_backward": 1}
        want_2d = {"conv KD=1": 35, "wgrad KD=1": 18, "bce_dice_forward": 1, "bce_dice_backward": 1}
        for tag, argv, want in (
            ("unet", unet_argv("api3d", "config.epoch_scan=true"), want_3d),
            ("unet2d", ["config=unet2d", *base_argv("api2d", "config.epoch_scan=true")], want_2d),
        ):
            cfg = compose(argv, job_name="train", make_run_dir=False)
            cmp = graph_against_eager(torch, dev, cfg, 4, tag)
            replay, eager_step, (graph_l, eager_l, again_l) = cmp["replay"], cmp["eager_step"], cmp["losses"]
            check(replay == eager_step == want, f"[17] {tag} hand kernels by name: one replay {replay}, one eager "
                                                f"step {eager_step}, want {want}")
            # step 0 ran eagerly in both (the graph's warm-up); step 1 is the graph's first replay
            rel = abs(graph_l[1].item() - eager_l[1].item()) / abs(eager_l[1].item())
            check(rel <= 1e-3, f"[17] {tag} first replayed step's loss graph {graph_l[1].item()} vs eager "
                               f"{eager_l[1].item()}")
            # the graph may differ from the eager loop only as much as the eager loop differs from itself
            # (UNet2D's step is not reproducible run to run; UNet3D's is, bit for bit)
            limit = 2 * cmp["spread"] + 1e-6
            check(cmp["distance"] <= limit, f"[17] {tag} weights after an epoch, graph vs eager: relative L2 "
                                            f"{cmp['distance']}, eager vs eager {cmp['spread']}")
            times = cmp["ms"]
            print(f"[17] {card}: epoch_scan {tag} ({cfg.patch_size} x {BATCH}, bf16): ms per step, CUDA events over "
                  f"an epoch of 4 replays, in turns: graph {times['graph'][0]:.3f} / {times['graph'][1]:.3f}, eager "
                  f"loop of the same step {times['eager'][0]:.3f} / {times['eager'][1]:.3f}; one replay's hand "
                  f"kernels by name {replay} (one eager step's: {eager_step}); first replayed step's loss graph "
                  f"{graph_l[1].item():.6f} / eager {eager_l[1].item():.6f} / eager again {again_l[1].item():.6f} "
                  f"(graph vs eager relative {rel:.3g}); first epoch's losses graph {graph_l.tolist()}, eager "
                  f"{eager_l.tolist()}, eager again {again_l.tolist()}; weights after the epoch, relative L2 graph "
                  f"vs eager {cmp['distance']:.4g}, eager vs eager again {cmp['spread']:.4g} (limit "
                  f"{limit:.4g}), with SGD in place of Adam {cmp['sgd_spread']:.4g}; operations torch flags as not "
                  f"reproducible in one eager step: {cmp['nondeterministic']}", flush=True)
        print(f"[17] {card}: UNet2D's bilinear upsampling (16 x 8^2 x 512 to 16 x 64^2 x 64, bf16), its backward "
              f"run twice on the same inputs: max |difference| {upsample_backward_spread(torch, dev)}", flush=True)

        # -- 17.5 dropout under the graph: res_unet at full width
        drop_argv = ["config=res_unet", f"config.patch_size={PATCH}, {PATCH}, {PATCH}",
                     *base_argv("drop", "config.epoch_scan=true", "config.samples_per_volume=16", "config.epochs=1")]
        out, _, losses, _, got, replayed, replay = run_train("drop", drop_argv, None, "res_unet epoch_scan")
        check(len(losses) == 2 and (out["scan"].eager_steps, out["scan"].replays) == (1, 1),
              f"[17] res_unet epoch_scan losses {losses}, {out['scan'].eager_steps} eager steps, "
              f"{out['scan'].replays} replays")
        net = out["model"]
        cfg = compose(drop_argv, job_name="train", make_run_dir=False)
        (drop,) = [m for m in net.modules() if isinstance(m, Dropout)]  # called at five levels, five shapes
        masks = {}

        def record(module, args, result):
            # the dropped positions into a buffer per call (by shape), made eagerly in the warm-up step
            # and written by each replay
            buf = masks.setdefault(tuple(result.shape), torch.zeros(result.shape, dtype=torch.bool, device=dev))
            buf.copy_((result == 0) & (args[0] != 0))

        hook = drop.register_forward_hook(record)
        ds = make_dataset(cfg, is_train=True, device=dev)
        opt = optim.make_optimizer(cfg, net.parameters())
        step = train.make_train_step(models.make_forward(cfg, net), opt, train.make_loss_and_metric(cfg))
        scan = make_epoch_scan(cfg, net, opt, step, stack_store([v[0] for v in ds.volumes]),
                               stack_store([v[1] for v in ds.volumes]))
        plan = build_epoch_plan(2, 32, BATCH, np.asarray([v[0].shape[:3] for v in ds.volumes]), cfg.patch_size,
                                np.random.default_rng(SEED))
        scan.start_epoch(*plan)
        scan.capture()  # runs step 0; the replays run steps 1-3
        seen = []
        for _ in range(3):
            scan.graph.replay()
            seen.append([m.clone() for m in masks.values()])
        hook.remove()
        check(len(masks) == 5, f"[17] res_unet: dropout masks of {len(masks)} shapes, not 5")
        shares = [torch.cat([m.flatten() for m in replay]).float().mean().item() for replay in seen]
        check(all(not torch.equal(a, b) for r1, r2 in zip(seen, seen[1:]) for a, b in zip(r1, r2) if a.any()),
              "[17] res_unet: a replay repeated a mask")
        check(all(0.5 < s < 0.7 for s in shares) and torch.isfinite(scan.losses).all().item(),
              f"[17] res_unet dropped shares {shares}, losses {scan.losses.tolist()}")
        print(f"[17] res_unet (Dropout 0.6 at 5 levels) under epoch_scan: train.main 1 epoch of 2 steps, losses "
              f"{[round(v, 5) for v in losses]}, launches {got} (step 0) and {replayed} (one replay, whose hand "
              f"kernels by name were {replay}); 3 replays of its graph drew 3 different masks at every level, "
              f"dropping {', '.join(f'{100 * s:.2f}%' for s in shares)} of the elements; losses "
              f"{[round(v, 5) for v in scan.losses.tolist()]}", flush=True)
        del out, net, scan, opt, step, ds, seen, masks

        # -- 17.6 the worker loader (data_backend=grain)
        grain_argv = unet_argv("grain", "config.data_backend=grain", "config.grain_workers=2",
                               "config.samples_per_volume=16", "config.epochs=1")
        cfg = compose(grain_argv, job_name="train", make_run_dir=False)
        firsts = []
        for workers in (0, 2):
            batches = iter(WorkerPatchDataset(cfg, worker_count=workers, pin_memory=True))
            firsts.append(next(batches))
            batches.close()
        check(all(torch.equal(a, b) for a, b in zip(*firsts)), "[17] grain: first batch of 2 workers != of 0")
        check(firsts[1][0].is_pinned() and firsts[1][0].shape == (BATCH, PATCH, PATCH, PATCH, 1),
              f"[17] grain batch {tuple(firsts[1][0].shape)}, pinned {firsts[1][0].is_pinned()}")
        loader = WorkerPatchDataset(compose(grain_argv + ["config.samples_per_volume=64"], job_name="train",
                                            make_run_dir=False), worker_count=2, pin_memory=True)
        t0 = time.perf_counter()
        stamps = [time.perf_counter() - t0 for _ in loader]
        n = len(stamps)
        rate = (n - 1) / (stamps[-1] - stamps[0])
        _, _, losses, wall, got, _, _ = run_train("grain", grain_argv, 2, "grain")
        check(len(losses) == 2, f"[17] grain losses {losses}")
        print(f"[17] {card}: data_backend=grain, 2 workers, 16 x {PATCH}^3 from the two 256x256x128 volumes: the "
              f"first batch equals grain_workers=0's; the loader alone {n} batches in {stamps[-1]:.2f} s, the first "
              f"after {stamps[0]:.2f} s (spawn and load), then {rate:.2f} batches/s; train.main one epoch of 2 steps "
              f"in {wall:.1f} s, launches {got}, losses {[round(v, 5) for v in losses]}; [17] took "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
        e2e_per_volume = wall / N_VOLUMES
        kept = Path(tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT / "build"))
        atexit.register(shutil.rmtree, kept, ignore_errors=True)  # [14] compares the served masks with these
        predict_masks = [Path(shutil.copy(m, kept / m.name)) for m in masks]
        print(f"[3] predict.main: {N_VOLUMES} volumes, {n_tiles} tiles each, {batches} forward batches, "
              f"launches {predict_launches}, {e2e_per_volume:.3f} s per volume end to end (pipelined); "
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
    atexit.register(shutil.rmtree, work, ignore_errors=True)  # [13] reads this run: it goes at exit, whatever fails
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
    unet2d_run = (work, run / "latest_checkpoint.ckpt", one, mask_file, batches)  # [13] reads it

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

    # -- 13. the predict options at full width, and their cost ---------------
    predict_options(torch, dev, card, zero_counters, read_counters, unet2d_run, e2e_per_volume)

    # -- 14. serving: serve_once, the Predictor, the exported programs ---------
    serving_phase(torch, card, zero_counters, read_counters, unet2d_run, predict_masks)

    # -- 15. the 3-D zoo at full width: train, predict, new conv shapes, card vs CPU, export
    zoo_errs = zoo_phase(torch, dev, card, zero_counters, read_counters, unet2d_run[0] / "data")
    max_err, dgrad_err, wgrad_err = (max(max_err, zoo_errs["fwd"]), max(dgrad_err, zoo_errs["dgrad"]),
                                     max(wgrad_err, zoo_errs["wgrad"]))

    # -- 16. the 2-D zoo at full width: train, predict, new conv shapes, card vs CPU
    zoo2d_errs = zoo2d_phase(torch, dev, card, zero_counters, read_counters, unet2d_run[0] / "data")
    err2d = {key: max(err2d[key], zoo2d_errs[key]) for key in err2d}

    # -- 17. the data backends and the epoch graph: device augmentation, epoch_scan, the worker loader
    def add_launches(replayed):
        """Launches a CUDA graph made past the wrappers in a main path's run, into the kernel line's."""
        for name, n in replayed.items():
            launches[name] += n

    data_phase(torch, dev, card, zero_counters, read_counters, add_launches, unet2d_run[0] / "data")

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
