#!/usr/bin/env python3
"""Times the PyTorch port's bf16 conv kernels against cuDNN on one CUDA card.

    python3 scripts/bench_torch_conv_kernels.py [fwd|dgrad|wgrad ...]

from the repository root, on a machine with a CUDA card and ``nvcc``. For
each of the 18 convs of UNet3D (batch 16 x 64^3, ``config=unet``) and of
UNet2D (16 x 128^2, ``config=unet2d``) it runs the port's kernel through its
wrapper (``conv3d_bn_relu``/``conv2d_bn_relu``, ``conv3d_input_grad``/
``conv2d_input_grad``, ``conv3d_wgrad``/``conv2d_wgrad``), prints its error
against the plain version relative to max(1, max|plain|) (f32 plain
versions from the same bf16 inputs; f64 for the weight gradient) and its
time beside cuDNN's for the same function in bf16, both by CUDA events over
10 calls after a warm-up, and the sums over the 18 convs. It imports nothing
of JAX. The first line is the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu as conv  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_wgrad as wg  # noqa: E402

# (Cin, Cout, grid side) of the 18 convs, in block order
UNET3D = [(1, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16), (128, 128, 16), (128, 256, 8),
          (256, 256, 8), (256, 512, 4), (512, 512, 4), (512, 256, 8), (256, 256, 8), (256, 128, 16),
          (128, 128, 16), (128, 64, 32), (64, 64, 32), (64, 32, 64), (32, 32, 64)]
UNET2D = [(1, 64, 128), (64, 64, 128), (64, 128, 64), (128, 128, 64), (128, 256, 32), (256, 256, 32),
          (256, 512, 16), (512, 512, 16), (512, 512, 8), (512, 512, 8), (1024, 256, 16), (256, 256, 16),
          (512, 128, 32), (128, 128, 32), (256, 64, 64), (64, 64, 64), (128, 64, 128), (64, 64, 128)]
BATCH = 16


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(op, nd, convs, gen):
    dev = torch.device("cuda")
    kernel_sum = cudnn_sum = 0.0
    for i, (cin, cout, side) in enumerate(convs):
        if op == "dgrad" and cin == 1:  # the stem's input is data: its input gradient is never taken
            continue
        spatial = (side,) * nd
        x = torch.randn((BATCH, *spatial, cin), device=dev, generator=gen).bfloat16()
        g = torch.randn((BATCH, *spatial, cout), device=dev, generator=gen).bfloat16()
        taps = 3**nd
        w = (torch.randn((3,) * nd + (cin, cout), device=dev, generator=gen)
             * (taps * (cout if op == "dgrad" else cin)) ** -0.5).bfloat16()
        b = torch.zeros(cout, device=dev)
        xc, gc, wc = x.movedim(-1, 1), g.movedim(-1, 1), w.permute(nd + 1, nd, *range(nd)).contiguous()
        if op == "fwd":
            fn = conv.conv3d_bn_relu if nd == 3 else conv.conv2d_bn_relu
            got, want = fn(x, w, b), (conv.conv3d_bn_relu_reference if nd == 3 else conv.conv2d_bn_relu_reference)(
                x.float(), w.float(), b)
            kernel = lambda: fn(x, w, b)  # noqa: E731
            f = torch.nn.functional.conv3d if nd == 3 else torch.nn.functional.conv2d
            library = lambda: torch.relu(f(xc, wc, b.bfloat16(), padding=1))  # noqa: E731
        elif op == "dgrad":
            fn = conv.conv3d_input_grad if nd == 3 else conv.conv2d_input_grad
            got = fn(g, w)
            want = (conv.conv3d_input_grad_reference if nd == 3 else conv.conv2d_input_grad_reference)(
                g.float(), w.float())
            kernel = lambda: fn(g, w)  # noqa: E731
            f = torch.nn.grad.conv3d_input if nd == 3 else torch.nn.grad.conv2d_input
            library = lambda: f((BATCH, cin, *spatial), wc, gc, padding=1)  # noqa: E731
        else:
            fn = wg.conv3d_wgrad if nd == 3 else wg.conv2d_wgrad
            got = fn(x, g)
            want = (wg.conv3d_wgrad_reference if nd == 3 else wg.conv2d_wgrad_reference)(x.double(), g.double())
            kernel = lambda: fn(x, g)  # noqa: E731
            f = torch.nn.grad.conv3d_weight if nd == 3 else torch.nn.grad.conv2d_weight
            library = lambda: f(xc, (cout, cin) + (3,) * nd, gc, padding=1)  # noqa: E731
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item() / max(1.0, want.abs().max().item())
        k_ms, c_ms = cuda_ms(kernel), cuda_ms(library)
        kernel_sum, cudnn_sum = kernel_sum + k_ms, cudnn_sum + c_ms
        print(f"{op} {nd}d {i:2d} {cin:4d}->{cout:<4d} @{side:3d}: err {err:.2e} kernel {k_ms:.3f} "
              f"cudnn {c_ms:.3f}", flush=True)
    print(f"{op} {nd}d SUM kernel {kernel_sum:.3f} cudnn {cudnn_sum:.3f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_conv_kernels: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for op in sys.argv[1:] or ["fwd", "dgrad", "wgrad"]:
        for nd, convs in ((3, UNET3D), (2, UNET2D)):
            run(op, nd, convs, gen)


if __name__ == "__main__":
    main()
