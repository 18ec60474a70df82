"""The port runs without JAX: imported with ``jax``, ``flax`` and the JAX
package itself blocked, it still builds UNet3D and UNet2D and runs a
forward and a train step of each on the CPU, the sliding window and the
whole-volume forward under tta (and the mean-logits blend), train steps with the
options of ``train.py`` (adamw with a clip, grad_accum, EMA, remat, focal
and multiclass losses, sgd), a serving ``Predictor``, an export of its
program and a load of it, the offline filters, a forward of each of the nine 3-D networks of the
zoo's first part at a narrow width, and a forward and a train step of each of the six of its second
part (densevoxelnet, densenet, fcn3d, highres2dnet, segnet, unetpp) at their fixed widths and test sizes,
the four of its third part (fcn2d, deeplab, pspnet, miniseg) built at their JAX widths and a forward and a
train step of MiniSeg, a forward and a train step of each transformer (unetr, vtnet) at a narrow width, the
on-device augmentation and an ``epoch_scan`` epoch; ``grain`` is blocked too (the card's machine has none);
no source of the port or ``chip_smoke.py`` imports any of them; and ``chip_smoke.py`` refuses to run where
there is no CUDA card."""

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
sys.modules["grain"] = None
import importlib, pkgutil
import numpy as np
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
from {PORT}.ops.sliding_window import whole_volume_predict
from {PORT}.predict import make_forward_fn
tta = make_forward_fn(ConfigDict(network="unet", tta="flips"), model)
mask = sliding_window_predict(tta, torch.randn(20, 16, 24, 1), (16, 16, 16), (4, 4, 4), 2, overlap_mode="mean_logits",
                              sync=False)()
assert mask.shape == (1, 20, 16, 24) and mask.dtype == np.int32
mask = whole_volume_predict(tta, torch.randn(20, 16, 18, 1), pad_multiple=16, sync=False)()
assert mask.shape == (1, 20, 16, 18) and mask.dtype == np.int32
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
from {PORT}.data.transforms import ZNormalization
from {PORT}.serving import Predictor, export_predictor, load_exported_predictor
from {PORT}.utils.filters import gaussian_high_pass, gaussian_low_pass
serve_cfg = ConfigDict(network="unet", in_classes=1, patch_size=(16, 16, 16), patch_overlap=(4, 4, 4), batch_size=2,
                       precision="float32", platform="cpu")
served = UNet3D(1, 2, 2).eval()
predictor = Predictor(serve_cfg, model=served, params=served.state_dict())
raw = np.random.default_rng(0).normal(size=(1, 20, 16, 18)).astype(np.float32)
mask = predictor.predict_array(raw)
assert mask.shape == (1, 20, 16, 18) and mask.dtype == np.int32
exported = load_exported_predictor(export_predictor(predictor, (20, 16, 18)))
assert (exported(served.state_dict(), ZNormalization().normalize_array(raw)) == mask).all()
assert np.allclose(gaussian_low_pass(raw[0]) + gaussian_high_pass(raw[0]), raw[0], atol=1e-4)
from {PORT}.models.registry import model_class
zoo = {{"res_unet": (1, 2, 4), "vnet": (True, 1, 2), "highresnet": (1, 2), "csrnet": (1, 2, 4), "er_net": (2, 1),
       "re_net": (1,), "IS": (1, 2, 4), "dunet": (1, 2, 8), "fusionnet": (1, 2, 4, 4)}}
for network, args in zoo.items():
    net = model_class(network)(*args).eval()
    with torch.inference_mode():
        y = make_forward(ConfigDict(network=network), net)(torch.randn(1, 16, 16, 16, 1))
    assert y.shape == (1, 16, 16, 16, 2) and y.dtype == torch.float32 and torch.isfinite(y).all(), network
# the six of the zoo's second part at their fixed widths: a forward and a train step each
for network, patch in (("densevoxelnet", (16, 16, 16)), ("densenet", (16, 16, 16)), ("fcn3d", (24, 24, 24)),
                       ("highres2dnet", (1, 32, 32)), ("segnet", (1, 32, 32)), ("unetpp", (1, 32, 32))):
    cfgz = ConfigDict(network=network, out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3)
    net = model_class(network)(1, 2).eval()
    forward = make_forward(cfgz, net)
    with torch.inference_mode():
        y = forward(torch.randn(1, *patch, 1))
    assert y.shape == (1, *patch, 2) and y.dtype == torch.float32 and torch.isfinite(y).all(), network
    step = make_train_step(forward, make_optimizer(cfgz, net.train().parameters()), make_loss_and_metric(cfgz))
    loss, dice = step(torch.randn(2, *patch, 1), (torch.rand(2, *patch, 1) > 0.5).float())
    assert torch.isfinite(loss) and 0 <= float(dice) <= 1, network
# the four of the 2-D zoo's third part built at their JAX widths, and a forward and a train step of MiniSeg
for network, count in (("fcn2d", 134283970), ("deeplab", 58158402), ("pspnet", 27494341), ("miniseg", 99146)):
    cfgz = ConfigDict(network=network, in_classes=1, out_classes=2, precision="float32", loss="bce", optimizer="adam",
                      init_lr=1e-3)
    net = build_model(cfgz)
    assert sum(p.numel() for p in net.parameters()) == count, network
forward = make_forward(cfgz, net.eval())
with torch.inference_mode():
    y = forward(torch.randn(1, 1, 32, 32, 1))
assert y.shape == (1, 1, 32, 32, 2) and y.dtype == torch.float32 and torch.isfinite(y).all()
step = make_train_step(forward, make_optimizer(cfgz, net.train().parameters()), make_loss_and_metric(cfgz))
loss, dice = step(torch.randn(2, 1, 32, 32, 1), (torch.rand(2, 1, 32, 32, 1) > 0.5).float())
assert torch.isfinite(loss) and 0 <= float(dice) <= 1
# the transformers at narrow widths: a forward and a train step each
for network, args, patch in (("unetr", ((32, 16, 16), 1, 2, 32, 16, 4), (32, 16, 16)),
                             ("vtnet", (2, 1, 12, 4), (32, 32, 32))):
    cfgz = ConfigDict(network=network, out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3)
    net = model_class(network)(*args).eval()
    with torch.inference_mode():
        y = net(torch.randn(1, *patch, 1))
    assert y.shape == (1, *patch, 2) and y.dtype == torch.float32 and torch.isfinite(y).all(), network
    step = make_train_step(net, make_optimizer(cfgz, net.train().parameters()), make_loss_and_metric(cfgz))
    loss, dice = step(torch.randn(2, *patch, 1), (torch.rand(2, *patch, 1) > 0.5).float())
    assert torch.isfinite(loss) and 0 <= float(dice) <= 1, network
from {PORT}.data.device_aug import augment_pair
from {PORT}.ops.epoch_scan import build_epoch_plan, make_epoch_scan, stack_store
src, gt = augment_pair(torch.Generator().manual_seed(0), torch.randn(1, 20, 20, 20), (torch.rand(1, 20, 20, 20) > 0.5).float())
assert src.shape == (1, 20, 20, 20) and torch.isfinite(src).all() and set(gt.unique().tolist()) <= {{0.0, 1.0}}
cfgs = ConfigDict(out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3, patch_size=(16, 16, 16), aug=True, seed=0)
net = UNet3D(1, 2, 2).train()
opt = make_optimizer(cfgs, net.parameters())
vols = [src.movedim(0, -1), gt.movedim(0, -1)]
scan = make_epoch_scan(cfgs, net, opt, make_train_step(net, opt, make_loss_and_metric(cfgs)), stack_store(vols[:1] * 2),
                       stack_store(vols[1:] * 2))
losses, dices = scan(*build_epoch_plan(2, 2, 2, (20, 20, 20), (16, 16, 16), np.random.default_rng(0)))
assert losses.shape == (2,) and torch.isfinite(losses).all()
blocked = ("jax", "flax", "jaxlib", "grain", "{JAX_PACKAGE}")
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
                assert top not in ("jax", "flax", "jaxlib", "grain", JAX_PACKAGE), f"{path}: {line}"


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
