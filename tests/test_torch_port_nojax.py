"""The port runs without JAX: imported with ``jax``, ``flax`` and the JAX
package itself blocked, it still builds UNet3D and UNet2D and runs a
forward and a train step of each on the CPU, and train steps with the
options of ``train.py`` (adamw with a clip, grad_accum, EMA, remat, focal
and multiclass losses, sgd); no source of the port or ``chip_smoke.py`` imports
any of them; and ``chip_smoke.py`` refuses to run where there is no CUDA
card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

ROOT = Path(__file__).resolve().parents[1]
PORT = "general_medical_image_segmentation_cnn_framework_tpu_torch"
JAX_PACKAGE = "general_medical_image_segmentation_cnn_framework_tpu"

_NO_JAX = f"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["{JAX_PACKAGE}"] = None
import importlib, pkgutil
import torch
import {PORT}
for m in pkgutil.walk_packages({PORT}.__path__, "{PORT}."):
    importlib.import_module(m.name)
from {PORT}.models.three_d.unet3d import UNet3D
from {PORT}.ops.sliding_window import sliding_window_predict
torch.manual_seed(0)
model = UNet3D(1, 2, 2).eval()
with torch.inference_mode():
    y = model(torch.randn(1, 16, 16, 16, 1))
assert y.shape == (1, 16, 16, 16, 2) and y.dtype == torch.float32 and torch.isfinite(y).all()
mask = sliding_window_predict(model, torch.randn(20, 16, 18, 1), (16, 16, 16), (4, 4, 4), 2)
assert mask.shape == (20, 16, 18) and mask.dtype == torch.int8
from {PORT}.config import ConfigDict
from {PORT}.train import make_loss_and_metric, make_optimizer, make_train_step
cfg = ConfigDict(out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3)
model.train()
step = make_train_step(model, make_optimizer(cfg, model.parameters()), make_loss_and_metric(cfg))
loss, dice = step(torch.randn(2, 16, 16, 16, 1), (torch.rand(2, 16, 16, 16, 1) > 0.5).float())
assert torch.isfinite(loss) and 0 <= float(dice) <= 1
from {PORT}.models import build_model, make_forward
cfg2d = ConfigDict(network="unet2d", in_classes=1, out_classes=2, precision="float32", init_type="kaiming", seed=0,
                   loss="bce", optimizer="adam", init_lr=1e-3)
unet2d = build_model(cfg2d).eval()
with torch.inference_mode():
    y = unet2d(torch.randn(2, 16, 16, 1))
assert y.shape == (2, 16, 16, 2) and y.dtype == torch.float32 and torch.isfinite(y).all()
unet2d.train()
step = make_train_step(make_forward(cfg2d, unet2d), make_optimizer(cfg2d, unet2d.parameters()), make_loss_and_metric(cfg2d))
loss, dice = step(torch.randn(2, 1, 16, 16, 1), (torch.rand(2, 1, 16, 16, 1) > 0.5).float())
assert torch.isfinite(loss) and 0 <= float(dice) <= 1
from {PORT}.optim import EMA
from {PORT}.convert import optimizer_state_from_optax
cfg = ConfigDict(out_classes=2, loss="focal", optimizer="adamw", weight_decay=0.01, grad_clip=1.0, init_lr=1e-3)
remat = UNet3D(1, 2, 2, remat=True, remat_policy="conv").train()
step = make_train_step(remat, make_optimizer(cfg, remat.parameters()), make_loss_and_metric(cfg), 2)
ema = EMA(remat, 0.99)
loss, dice = step(torch.randn(2, 16, 16, 16, 1), (torch.rand(2, 16, 16, 16, 1) > 0.5).float())
ema.update(remat)
assert torch.isfinite(loss) and 0 <= float(dice) <= 1
cfg3 = ConfigDict(out_classes=3, loss="bce", optimizer="sgd", momentum=0.9, init_lr=1e-3)
net3 = UNet3D(1, 3, 2, remat=True).train()
step = make_train_step(net3, make_optimizer(cfg3, net3.parameters()), make_loss_and_metric(cfg3))
loss, dice = step(torch.randn(2, 16, 16, 16, 1), torch.randint(0, 3, (2, 16, 16, 16, 1)).float())
assert torch.isfinite(loss) and 0 <= float(dice) <= 1
blocked = ("jax", "flax", "jaxlib", "{JAX_PACKAGE}")
loaded = [k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in blocked]
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # one torch thread, as torch_port_threads sets here
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_never_import_jax():
    for path in [*(ROOT / PORT).rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "flax", "jaxlib", JAX_PACKAGE), f"{path}: {line}"


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
