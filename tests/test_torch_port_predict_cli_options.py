"""The port's ``predict.main`` with each predict option of the JAX package
against JAX ``predict.predict`` on the same weights, f32 on the CPU (UNet3D
at init_features=4, the 32^3 synthetic volumes): the same masks and the
same ``metrics.csv``, for the blends and tta (``whole_volume`` and
``shape_bucket`` are in ``test_torch_port_predict_pipeline.py``)."""

import numpy as np
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from general_medical_image_segmentation_cnn_framework_tpu import predict as jax_predict
from general_medical_image_segmentation_cnn_framework_tpu.checkpoint import save_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu.config import compose
from general_medical_image_segmentation_cnn_framework_tpu.data.io import read_volume
from general_medical_image_segmentation_cnn_framework_tpu_torch import predict as port_predict
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import convert_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from test_torch_port_unet3d import jax_unet


def _overrides(data, out, ckpt, *extra):
    return [
        "config=unet",
        f"config.pred_data_path={data}/source",
        f"config.pred_gt_path={data}/label",
        f"config.output_dir={out}",
        f"config.ckpt={ckpt}",
        "config.patch_size=16, 16, 16",
        "config.patch_overlap=4, 4, 4",
        "config.batch_size=4",  # 27 tiles a volume: the last of 7 batches padded
        "config.precision=float32",
        *extra,
    ]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The f=4 UNet3D's seeded weights (masks of a few % foreground, with
    and without tta) as a JAX .ckpt and converted."""
    model, variables = jax_unet(4, seed=17)
    root = tmp_path_factory.mktemp("ckpt")
    jax_ckpt, port_ckpt = root / "latest_checkpoint.ckpt", root / "unet3d.pt"
    save_checkpoint(jax_ckpt, variables["params"], variables["batch_stats"], {}, epoch=1)
    convert_checkpoint(jax_ckpt, port_ckpt)
    return model, jax_ckpt, port_ckpt


def run_both(model, jax_ckpt, port_ckpt, data, out, options, monkeypatch):
    """JAX ``predict.predict`` and the port's ``predict.main`` with the same
    options: their masks and ``metrics.csv`` are the same, and the masks are
    not constant."""
    jax_cfg = compose(_overrides(data, out / "jax", jax_ckpt, *options), job_name="predict")
    jax_predict.predict(model=model, config=jax_cfg)
    monkeypatch.setattr(port_predict, "build_model", lambda config: UNet3D(1, 2, 4))
    port_predict.main(_overrides(data, out / "port", port_ckpt, *options, "config.platform=cpu"))

    (port_dir,) = (out / "port").glob("predict-*/*")
    (jax_dir,) = (out / "jax").glob("predict-*/*")
    port_masks = sorted(port_dir.glob("pred_file/pred-*.nii.gz"))
    jax_masks = sorted(jax_dir.glob("pred_file/pred-*.nii.gz"))
    assert [p.name for p in port_masks] == [p.name for p in jax_masks] == ["pred-0000.nii.gz", "pred-0001.nii.gz"]
    for a, b in zip(port_masks, jax_masks):
        got, want = read_volume(a), read_volume(b)
        assert got.data.shape == want.data.shape == (1, 32, 32, 32)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)
        assert 0.0 < got.data.mean() < 1.0  # the mask is not constant
    assert (port_dir / "metrics.csv").read_text() == (jax_dir / "metrics.csv").read_text()


@pytest.mark.parametrize("options", [
    ("config.blend=mean_logits",),
    ("config.tta=flips",),
    ("config.tta=flips:dw", "config.blend=average"),
], ids=lambda o: "+".join(v.split(".", 1)[1] for v in o))
def test_predict_option_matches_jax(options, checkpoints, synthetic_dataset, tmp_path, monkeypatch):
    """Masks (values as written, affine) and ``metrics.csv`` byte for byte,
    for: the mean-logits blend, tta over the three axes, and tta over two
    axes with the host-aggregated average blend (fractional masks)."""
    run_both(*checkpoints, synthetic_dataset / "test", tmp_path, options, monkeypatch)
