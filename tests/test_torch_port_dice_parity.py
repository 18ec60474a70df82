"""Dice parity of the port with the JAX package (ROADMAP queue 1 item 5,
the ±0.002 bar of BASELINE.json): the verify recipe (3 bright-ball
training volumes of 32^3, 16^3 patches, batch 4, 8 patches a volume, 40
epochs, lr 0.003, UNet3D at f=32) trained in both packages from the same init (the JAX
``init_train_state``, written as a JAX checkpoint and carried over by
``convert.py``; both resume it with ``load_mode=1`` at epoch 0), f32 on
the CPU, ``data_backend=threaded`` in both (their host patch queues draw
the same patches; the device backends draw from different generators).
Each package then predicts the 2 test volumes with its own weights, and
the mean dice of the two ``metrics.csv`` files must agree within 0.002.

Marked ``slow`` (several minutes on the CPU), so it is not part of the
tier-1 run: ``python -m pytest tests/test_torch_port_dice_parity.py -m slow -s``
prints both dice."""

import csv

import pytest

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import jax  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu import predict as jax_predict
from general_medical_image_segmentation_cnn_framework_tpu import train as jax_train
from general_medical_image_segmentation_cnn_framework_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu.config import compose as jax_compose
from general_medical_image_segmentation_cnn_framework_tpu.models.registry import build_model as jax_build_model
from general_medical_image_segmentation_cnn_framework_tpu_torch import predict as port_predict
from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import convert_checkpoint

BAR = 0.002


def _recipe(data, out, *extra):
    return [
        "config=unet", "config.platform=cpu", "config.precision=float32", "config.data_backend=threaded",
        f"config.data_path={data}/train/source", f"config.gt_path={data}/train/label",
        f"config.pred_data_path={data}/test/source", f"config.pred_gt_path={data}/test/label",
        f"config.output_dir={out}", "config.patch_size=16, 16, 16", "config.batch_size=4",
        "config.samples_per_volume=8", "config.init_lr=0.003", "config.epochs_per_checkpoint=1000", *extra,
    ]


def _mean_dice(out):
    (path,) = out.glob("predict-*/*/metrics.csv")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return float(rows[-1][rows[0].index("dice")])


@pytest.mark.slow
def test_verify_recipe_dice_matches_jax(synthetic_dataset, tmp_path):
    cfg = jax_compose(_recipe(synthetic_dataset, tmp_path / "init"), job_name="train")
    model = jax_build_model(cfg)
    params, batch_stats, opt_state, _ = jax_train.init_train_state(cfg, model, jax.random.PRNGKey(0))
    jax_init, port_init = tmp_path / "init.ckpt", tmp_path / "init.pt"
    jax_save_checkpoint(jax_init, params, batch_stats, opt_state, epoch=0)
    convert_checkpoint(jax_init, port_init)

    dice = {}
    for name, train_main, predict_main, init in (
        ("jax", jax_train.main, jax_predict.main, jax_init),
        ("port", port_train.main, port_predict.main, port_init),
    ):
        runs = tmp_path / name
        train_main(_recipe(synthetic_dataset, runs, "config.epochs=40", "config.load_mode=1", f"config.ckpt={init}"))
        (run,) = runs.glob("train-*/*")
        predict_main(_recipe(synthetic_dataset, tmp_path / f"{name}_pred", "config.patch_overlap=4, 4, 4",
                             f"config.ckpt={run / 'latest_checkpoint.ckpt'}"))
        dice[name] = _mean_dice(tmp_path / f"{name}_pred")
    print(f"verify recipe mean dice: JAX {dice['jax']:.6f}, port {dice['port']:.6f}, "
          f"|difference| {abs(dice['jax'] - dice['port']):.6f} (bar {BAR})")
    assert dice["jax"] > 0.9 and dice["port"] > 0.9
    assert abs(dice["jax"] - dice["port"]) <= BAR
