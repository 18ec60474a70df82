"""The training options of the port's ``train.main`` beyond the default
path, on the CPU at f32, UNet3D at init_features=4 on 16^3 patches of the
32^3 synthetic volumes: validation with its best checkpoint (the dice it
logs is the dice ``predict`` computes for the same weights; with
``whole_volume`` and ``tta`` the JAX ``evaluate``'s dice), the EMA
checkpoint (predict-only, resumed with the run), ``profile_dir``,
``jax_debug_nans`` and multiclass training. ``remat`` is in
``test_torch_port_remat.py``."""

import logging

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package makes the random weights: without it the file skips

from general_medical_image_segmentation_cnn_framework_tpu import train as jax_train
from general_medical_image_segmentation_cnn_framework_tpu.config import compose as jax_compose

from general_medical_image_segmentation_cnn_framework_tpu_torch import predict as port_predict
from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
from general_medical_image_segmentation_cnn_framework_tpu_torch.checkpoint import (
    load_checkpoint,
    restore_training_state,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict, compose
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from test_torch_port_unet3d import jax_unet, port_unet


def _args(data, out, *extra):
    return [
        "config=unet", "config.platform=cpu", "config.precision=float32",
        f"config.data_path={data}/train/source", f"config.gt_path={data}/train/label",
        f"config.val_data_path={data}/test/source", f"config.val_gt_path={data}/test/label",
        f"config.pred_data_path={data}/test/source", f"config.pred_gt_path={data}/test/label",
        f"config.output_dir={out}", "config.patch_size=16, 16, 16", "config.patch_overlap=4, 4, 4",
        "config.batch_size=4", "config.samples_per_volume=4", "config.epochs_per_checkpoint=5",
        "config.data_backend=threaded", *extra,
    ]


@pytest.fixture
def seeded_unet(monkeypatch):
    """The CLIs build the f=4 UNet3D with seeded random weights (BatchNorm
    statistics far from the identity, so that its masks are not empty)."""
    _, variables = jax_unet(4, seed=41)

    def build(config):
        model = port_unet(variables, 4)
        fresh = UNet3D(1, int(config.out_classes), 4, remat=bool(config.remat),
                       remat_policy=str(config.remat_policy or ""))
        sd = model.state_dict()
        if int(config.out_classes) != 2:  # a head of another width: its own init
            sd = {k: v for k, v in sd.items() if not k.startswith("head")} | {
                k: v for k, v in fresh.state_dict().items() if k.startswith("head")}
        fresh.load_state_dict(sd)
        return fresh

    monkeypatch.setattr(port_train, "build_model", build)
    monkeypatch.setattr(port_predict, "build_model", build)


def test_validation_best_and_ema_checkpoints(synthetic_dataset, tmp_path, seeded_unet):
    """One epoch of 3 steps with the item-8 options at once (adamw with
    weight decay, a global-norm clip, grad_accum=2, focal loss, remat, EMA,
    validation): finite losses; the validation dice equals predict's dice on
    the same volumes from ``best_checkpoint.ckpt``, which holds the
    optimizer state; ``ema_checkpoint.ckpt`` holds the EMA parameters with
    the run's BatchNorm statistics, predict reads it and a resume refuses it
    as predict-only; a resume from the latest file restores the EMA from the
    run's EMA file; validation with ``whole_volume=true`` and ``tta`` gives
    the JAX ``evaluate``'s dice for the same weights, and runs in
    ``train.main``."""
    options = ["config.optimizer=adamw", "config.weight_decay=0.01", "config.grad_clip=1.0", "config.grad_accum=2",
               "config.loss=focal", "config.remat=true", "config.remat_policy=conv", "config.ema_decay=0.9",
               "config.val_interval=1", "config.init_lr=1e-4", "config.epochs=1"]
    out = port_train.main(_args(synthetic_dataset, tmp_path / "runs", *options))
    (run,) = (tmp_path / "runs").glob("train-*/*")
    assert np.isfinite(out["loss"]) and out["model"].blocks[0].remat == "conv"

    best = load_checkpoint(run / "best_checkpoint.ckpt")
    assert best["epoch"] == 1 and best["optimizer"] == "adamw" and best["opt_state"]["state"]
    val_dice = out["best_val_dice"]
    port_predict.main(_args(synthetic_dataset, tmp_path / "pred", f"config.ckpt={run / 'best_checkpoint.ckpt'}"))
    (metrics,) = (tmp_path / "pred").glob("predict-*/*/metrics.csv")
    rows = [line.split(",") for line in metrics.read_text().splitlines()[1:]]
    assert 0.0 < val_dice < 1.0 and val_dice == pytest.approx(float(rows[-1][3]), rel=1e-12)

    latest = load_checkpoint(run / "latest_checkpoint.ckpt")
    ema = load_checkpoint(run / "ema_checkpoint.ckpt")
    assert ema["opt_state"] is None and ema["epoch"] == 1
    for name, t in ema["params"].items():
        if "running" in name:
            assert torch.equal(t, latest["params"][name])
    assert torch.equal(ema["params"]["blocks.3.conv.weight"], out["ema_params"]["blocks.3.conv.weight"])
    assert not torch.equal(ema["params"]["blocks.3.conv.weight"], latest["params"]["blocks.3.conv.weight"])
    port_predict.main(_args(synthetic_dataset, tmp_path / "pred_ema", f"config.ckpt={run / 'ema_checkpoint.ckpt'}"))
    assert list((tmp_path / "pred_ema").glob("predict-*/*/metrics.csv"))
    model = UNet3D(1, 2, 4)
    with pytest.raises(ValueError, match="predict-only"):
        restore_training_state(run / "ema_checkpoint.ckpt", model,
                               port_train.make_optimizer(ConfigDict(optimizer="adamw", init_lr=1e-3),
                                                         model.parameters()), "adamw")

    resumed = port_train.main(_args(synthetic_dataset, tmp_path / "resume", "config.optimizer=adamw",
                                    "config.ema_decay=0.9", "config.epochs=2", "config.load_mode=1",
                                    f"config.ckpt={run / 'latest_checkpoint.ckpt'}"))
    (run2,) = (tmp_path / "resume").glob("train-*/*")
    assert f"resumed EMA weights from {run / 'ema_checkpoint.ckpt'}" in (run2 / "train.log").read_text()
    assert load_checkpoint(run2 / "ema_checkpoint.ckpt")["epoch"] == 2 and resumed["epoch"] == 2

    # validation with whole_volume=true under tta: one forward a flip and volume, the dice of the JAX
    # evaluate on the same weights
    wv_args = _args(synthetic_dataset, tmp_path / "wv", "config.val_interval=1", "config.whole_volume=true",
                    "config.tta=flips:d", "config.epochs=1")
    jax_model, variables = jax_unet(4, seed=17)  # masks near the balls: dice 0.81, 0.73 without tta
    want = jax_train.evaluate(jax_compose(wv_args, job_name="train", make_run_dir=False), jax_model,
                              variables["params"], variables["batch_stats"], logging.getLogger("validation"))
    got = port_train.evaluate(compose(wv_args, job_name="train", make_run_dir=False),
                              port_unet(variables, 4), torch.device("cpu"), logging.getLogger("validation"))
    assert 0.0 < got < 1.0 and got == pytest.approx(want, rel=1e-12)
    assert np.isfinite(port_train.main(wv_args)["best_val_dice"])


def test_multiclass_training_validates_with_the_multiclass_metrics(synthetic_dataset, tmp_path, seeded_unet):
    """``out_classes=3``: softmax cross entropy on the integer labels, the
    foreground dice per step, and validation through the multiclass metrics."""
    out = port_train.main(_args(synthetic_dataset, tmp_path / "runs", "config.out_classes=3", "config.epochs=1",
                                "config.val_interval=1"))
    (run,) = (tmp_path / "runs").glob("train-*/*")
    assert np.isfinite(out["loss"]) and 0.0 <= out["dice"] <= 1.0 and 0.0 <= out["best_val_dice"] <= 1.0
    assert (run / "best_checkpoint.ckpt").exists()
    assert out["model"].head.weight.shape == (3, 4)


def test_profile_dir_writes_a_trace_and_jax_debug_nans_turns_on_anomaly_detection(synthetic_dataset, tmp_path,
                                                                                monkeypatch):
    """``profile_dir``: a ``torch.profiler`` trace of the loop in the
    directory; ``jax_debug_nans``: anomaly detection on in every step, and
    off again after the run."""
    anomaly = []
    make_step = port_train.make_train_step

    def recording_step(*args):
        step = make_step(*args)

        def run(x, gt):
            anomaly.append(torch.is_anomaly_enabled())
            return step(x, gt)

        return run

    monkeypatch.setattr(port_train, "make_train_step", recording_step)
    monkeypatch.setattr(port_train, "build_model", lambda config: UNet3D(1, 2, 2))
    port_train.main(_args(synthetic_dataset, tmp_path / "runs", "config.samples_per_volume=2", "config.epochs=1",
                          f"config.profile_dir={tmp_path / 'prof'}", "config.jax_debug_nans=true"))
    assert anomaly and all(anomaly) and not torch.is_anomaly_enabled()
    assert list((tmp_path / "prof").glob("*.pt.trace.json"))
