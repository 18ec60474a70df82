#!/usr/bin/env python3
"""Times the PyTorch port's fused BCE + dice kernels on one CUDA card.

    python3 scripts/bench_torch_loss_kernels.py [ROOT ...]

on a machine with a CUDA card and ``nvcc``. Each ROOT is a checkout of the
repository (default: the one that holds this script); each is measured in a
process of its own, in the order given, so two versions compare in one call
on one card (``ROOT_A ROOT_B ROOT_B ROOT_A``). It uses only the public
functions of ``ops/fused_bce_dice.py`` (``bce_dice_sums``, ``bce_dice_grads``,
``fused_bce_dice_metrics``), so it runs on any version of the port.

For the logits of UNet3D's train step (16 x 64^3 x 2 f32), UNet2D's
(16 x 1 x 128^2 x 2) and a ragged count (3 x 17 x 19 x 23), it prints per
wrapper call (sums, grads) the device time, the kernels a call launches, the
wrapper's time and the host's microseconds, measured as ``chip_smoke.py`` [5]
measures them (its ``loss_kernel_times``, 50 calls); and for the loss path as
the train step runs it (``chip_smoke.py``'s ``loss_path``:
``fused_bce_dice_metrics`` forward and ``torch.autograd.grad`` of the loss):
the kernels launched per forward + backward by name, their device time, and
the host's time per forward + backward. The timing code is this checkout's
``chip_smoke.py``, whatever ROOT holds. The first line is the card's name and
power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

SHAPES = ((16, 64, 64, 64), (16, 1, 128, 128), (3, 17, 19, 23))
CALLS = 50


def measure(root: str) -> None:
    import importlib.util

    import torch

    # the timing helpers of this checkout's chip_smoke.py, loaded by path: ROOT may hold another version
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import fused_bce_dice as op

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def short(key):
        return key.replace("void ", "").replace("(anonymous namespace)::", "")[:50]

    print(f"== {root}", flush=True)
    for shape in SHAPES:
        logits = 3.0 * torch.randn(*shape, 2, device=dev, generator=gen)
        gt = (torch.rand(*shape, 1, device=dev, generator=gen) > 0.7).float()
        scale = torch.full((1,), 0.5 / logits[..., 0].numel(), device=dev)
        for name, (dev_ms, per_call, wrap_ms, host_us) in smoke.loss_kernel_times(
                torch, op, logits, gt, scale, CALLS).items():
            print(f"{shape} {name}: device {dev_ms:.5f} ms in {sum(per_call.values()):g} kernels per call, wrapper "
                  f"{wrap_ms:.5f} ms, host {host_us:.1f} us", flush=True)
        run = smoke.loss_path(torch, op.fused_bce_dice_metrics, logits, gt)
        dev_ms, per_call = smoke.profiled_ms(torch, run, CALLS)
        _, host_us = smoke.wrapper_and_host(torch, run, CALLS)
        names = {}
        for key, n in per_call.items():
            names[short(key)] = names.get(short(key), 0) + n
        print(f"{shape} loss path, forward + backward: {sum(per_call.values()):g} kernels, device {dev_ms:.5f} ms, "
              f"host {host_us:.1f} us; " + ", ".join(f"{n} x{c:g}" for n, c in sorted(names.items())), flush=True)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        measure(sys.argv[2])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_loss_kernels: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", str(Path(root).resolve())], check=True)


if __name__ == "__main__":
    main()
