#!/usr/bin/env python3
"""Times the PyTorch port's warm train step and its max pools on one CUDA card.

    python3 scripts/bench_torch_train_step.py [ROOT ...]

on a machine with a CUDA card and ``nvcc``. Each ROOT is a checkout of the
repository (default: the one that holds this script); each is measured in a
process of its own, in the order given, so two versions compare in one call
on one card (``ROOT_A ROOT_B ROOT_B ROOT_A``). It uses only the port's
public entry points (``config.compose``, ``models.build_model`` /
``make_forward``, ``train.make_optimizer`` / ``make_loss_and_metric`` /
``make_train_step``, ``nn.blocks.max_pool``), so it runs on any version of
the port since its train step took a forward function.

For ``config=unet`` (UNet3D, f=32, 16 x 64^3) and ``config=unet2d``
(UNet2D, 16 x 1 x 128^2) at their defaults (bf16, Adam), with seeded
weights and a seeded batch on the card, it prints the warm train step's
time (CUDA events over 10 steps after 3, three times: the step
``chip_smoke.py`` [7] and [10] time), and the forward and backward of
``max_pool`` at each of the network's four pool inputs (bf16, CUDA events
over 20 calls after 3). The first line is the card's name and power
limit. It imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

NETWORKS = {"unet": ((64, 64, 64), (32, 64, 128, 256)), "unet2d": ((1, 128, 128), (64, 128, 256, 512))}
BATCH = 16


def events_ms(torch, fn, reps, warm=3):
    """Milliseconds per call of ``fn`` by CUDA events over ``reps`` calls after ``warm``."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from general_medical_image_segmentation_cnn_framework_tpu_torch import train
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models import build_model, make_forward
    from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import max_pool

    dev = torch.device("cuda")
    print(f"== {root}", flush=True)
    for network, (patch, widths) in NETWORKS.items():
        cfg = compose([f"config={network}", "config.precision=bfloat16", "config.optimizer=adam"],
                      job_name="train", make_run_dir=False)
        torch.manual_seed(0)
        model = build_model(cfg).to(dev).train()
        optimizer = train.make_optimizer(cfg, model.parameters())
        step = train.make_train_step(make_forward(cfg, model), optimizer, train.make_loss_and_metric(cfg))
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(BATCH, *patch, 1, device=dev, generator=gen)
        y = (torch.rand(BATCH, *patch, 1, device=dev, generator=gen) > 0.7).float()
        steps = [events_ms(torch, lambda: step(x, y), 10) for _ in range(3)]
        pools = []
        spatial = patch if network == "unet" else patch[1:]
        for level, width in enumerate(widths):
            shape = (BATCH, *(s >> level for s in spatial), width)
            a = torch.relu(torch.randn(*shape, device=dev, generator=gen)).bfloat16().requires_grad_()
            out = max_pool(a)
            ct = torch.randn_like(out)
            fwd = events_ms(torch, lambda: max_pool(a), 20)
            both = events_ms(torch, lambda: torch.autograd.grad(max_pool(a), a, ct), 20)
            pools.append(f"{'x'.join(map(str, shape))} forward {fwd:.4f} forward+backward {both:.4f}")
        print(f"{network} warm step (bf16, Adam, {BATCH}x{'x'.join(map(str, patch))}): "
              f"{', '.join(f'{t:.3f}' for t in steps)} ms; max_pool ms: {'; '.join(pools)}", flush=True)
        del model, optimizer, step, x, y
        torch.cuda.empty_cache()


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        measure(sys.argv[2])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_train_step: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", str(Path(root).resolve())], check=True)


if __name__ == "__main__":
    main()
