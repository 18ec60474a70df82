"""The port's sliding-window predict against the JAX package's, tile
program and CLI, at f32 with the same weights: UNet3D, and UNet2D on
depth-1 slices (``config=unet2d``)."""

import csv
import math

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from general_medical_image_segmentation_cnn_framework_tpu import predict as jax_predict
from general_medical_image_segmentation_cnn_framework_tpu.checkpoint import save_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu.config import compose
from general_medical_image_segmentation_cnn_framework_tpu.data.io import read_volume
from general_medical_image_segmentation_cnn_framework_tpu.ops.sliding_window import (
    sliding_window_predict as jax_sliding_window_predict,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch import predict as port_predict
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import convert_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.sliding_window import (
    prepare_volume,
    sliding_window_predict,
)
from test_torch_port_unet3d import jax_unet, port_unet


def test_sliding_window_crop_masks_match_jax():
    """One 32^3 volume, patch 16, overlap 4, batch 2 (27 tiles: the last
    batch is padded), crop-mode aggregation."""
    model, variables = jax_unet(4, seed=7)
    rng = np.random.default_rng(8)
    vol = rng.normal(size=(1, 32, 32, 32)).astype(np.float32)

    def forward(v, tiles):
        return model.apply(v, tiles, train=False)

    want = jax_sliding_window_predict(forward, variables, vol, (16, 16, 16), (4, 4, 4), batch_size=2)
    got = sliding_window_predict(
        port_unet(variables, 4), prepare_volume(vol, torch.device("cpu"), torch.float32),
        (16, 16, 16), (4, 4, 4), batch_size=2,
    )
    assert got.dtype == torch.int8 and got.shape == (32, 32, 32)
    np.testing.assert_array_equal(got.numpy()[None].astype(np.int32), want)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(v) if v else math.nan for v in row] for row in rows[1:]]


def test_predict_cli_matches_jax(synthetic_dataset, tmp_path, monkeypatch):
    """JAX ``predict.predict`` on a JAX .ckpt and the port's ``predict.main``
    on the converted checkpoint write the same masks and metrics.csv."""
    model, variables = jax_unet(4, seed=9)
    jax_ckpt, port_ckpt = tmp_path / "latest_checkpoint.ckpt", tmp_path / "unet3d.pt"
    save_checkpoint(jax_ckpt, variables["params"], variables["batch_stats"], {}, epoch=1)
    convert_checkpoint(jax_ckpt, port_ckpt)

    def overrides(out, ckpt):
        return [
            "config=unet",
            f"config.pred_data_path={synthetic_dataset}/test/source",
            f"config.pred_gt_path={synthetic_dataset}/test/label",
            f"config.output_dir={out}",
            f"config.ckpt={ckpt}",
            "config.patch_size=16, 16, 16",
            "config.patch_overlap=4, 4, 4",
            "config.batch_size=2",
            "config.precision=float32",
        ]

    jax_cfg = compose(overrides(tmp_path / "jax", jax_ckpt), job_name="predict")
    jax_predict.predict(model=model, config=jax_cfg)

    # the CLI builds the f=32 UNet3D of from_config; this test runs the f=4 one
    monkeypatch.setattr(port_predict, "build_model", lambda config: UNet3D(1, 2, 4))
    port_predict.main(overrides(tmp_path / "port", port_ckpt) + ["config.platform=cpu"])
    (port_dir,) = (tmp_path / "port").glob("predict-*/*")

    jax_masks = sorted((tmp_path / "jax").glob("predict-*/*/pred_file/pred-*.nii.gz"))
    port_masks = sorted(port_dir.glob("pred_file/pred-*.nii.gz"))
    assert [p.name for p in port_masks] == [p.name for p in jax_masks] == [
        "pred-0000.nii.gz", "pred-0001.nii.gz"
    ]
    for a, b in zip(port_masks, jax_masks):
        got, want = read_volume(a), read_volume(b)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)
        assert 0.0 < got.data.mean() < 1.0  # the mask is not constant

    (jax_csv,) = (tmp_path / "jax").glob("predict-*/*/metrics.csv")
    got_header, got_rows = _read_csv(port_dir / "metrics.csv")
    want_header, want_rows = _read_csv(jax_csv)
    assert got_header == want_header == ["precision", "recall", "jaccard", "dice", "hs95"]
    assert len(got_rows) == len(want_rows) == 3  # two volumes and the mean row
    np.testing.assert_allclose(got_rows, want_rows, rtol=0, atol=1e-6)
    assert (port_dir / "metrics.csv").read_text() == jax_csv.read_text()


def test_predict_cli_unet2d_matches_jax(synthetic_dataset, tmp_path):
    """``config=unet2d`` (full width, patch "1, 32, 32": every tile is one
    slice, the depth overlap clamped to 0): JAX ``predict.predict`` on a JAX
    .ckpt and the port's ``predict.main`` on the checkpoint converted by the
    CLI (which tells UNet2D from UNet3D by the tree) write the same masks
    and metrics.csv."""
    from general_medical_image_segmentation_cnn_framework_tpu.models.two_d.unet2d import UNet2D as FlaxUNet2D
    from general_medical_image_segmentation_cnn_framework_tpu_torch import convert
    from test_torch_port_unet3d import random_variables

    import jax.numpy as jnp

    model = FlaxUNet2D(in_channels=1, classes=2)
    variables = random_variables(model, jnp.zeros((1, 32, 32, 1)), seed=10)
    jax_ckpt, port_ckpt = tmp_path / "latest_checkpoint.ckpt", tmp_path / "unet2d.pt"
    save_checkpoint(jax_ckpt, variables["params"], variables["batch_stats"], {}, epoch=1)
    convert.main([str(jax_ckpt), str(port_ckpt)])

    def overrides(out, ckpt):
        return [
            "config=unet2d",
            f"config.pred_data_path={synthetic_dataset}/test/source",
            f"config.pred_gt_path={synthetic_dataset}/test/label",
            f"config.output_dir={out}",
            f"config.ckpt={ckpt}",
            "config.patch_size=1, 32, 32",
            "config.patch_overlap=4, 4, 4",
            "config.batch_size=8",
            "config.precision=float32",
        ]

    jax_predict.predict(model=model, config=compose(overrides(tmp_path / "jax", jax_ckpt), job_name="predict"))
    port_predict.main(overrides(tmp_path / "port", port_ckpt) + ["config.platform=cpu"])
    (port_dir,) = (tmp_path / "port").glob("predict-*/*")
    jax_masks = sorted((tmp_path / "jax").glob("predict-*/*/pred_file/pred-*.nii.gz"))
    port_masks = sorted(port_dir.glob("pred_file/pred-*.nii.gz"))
    assert [p.name for p in port_masks] == [p.name for p in jax_masks] == ["pred-0000.nii.gz", "pred-0001.nii.gz"]
    for a, b in zip(port_masks, jax_masks):
        got, want = read_volume(a), read_volume(b)
        np.testing.assert_array_equal(got.data, want.data)
        assert 0.0 < got.data.mean() < 1.0  # the mask is not constant
    (jax_csv,) = (tmp_path / "jax").glob("predict-*/*/metrics.csv")
    assert (port_dir / "metrics.csv").read_text() == jax_csv.read_text()
