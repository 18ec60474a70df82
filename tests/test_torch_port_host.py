"""The port's own copies of the JAX package's host modules against the
originals on the same inputs, and the device that ``config.platform``
selects (null, gpu or cuda: the card, raising without one; cpu: the CPU)."""

import datetime

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("jax")  # the JAX package is this file's oracle: without JAX the file skips

from general_medical_image_segmentation_cnn_framework_tpu import config as jax_config
from general_medical_image_segmentation_cnn_framework_tpu.data import io as jax_io
from general_medical_image_segmentation_cnn_framework_tpu.data import pipeline as jax_pipeline
from general_medical_image_segmentation_cnn_framework_tpu.data import transforms as jax_transforms
from general_medical_image_segmentation_cnn_framework_tpu_torch import config as port_config
from general_medical_image_segmentation_cnn_framework_tpu_torch import predict as port_predict
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io as port_io
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import pipeline as port_pipeline
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import transforms as port_transforms
from general_medical_image_segmentation_cnn_framework_tpu_torch.logging_utils import AverageMeter, TBWriter

NOW = datetime.datetime(2026, 1, 2, 3, 4, 5)
OVERRIDES = [
    "config=unet", "config.patch_size=32, 16, 8", "config.batch_size=3", "config.init_lr=0.003",
    "config.output_dir=/nonexistent/runs", "config.aug=true", "config.platform=cpu",
]


def test_compose_matches_jax():
    want = jax_config.compose(OVERRIDES, job_name="train", make_run_dir=False, now=NOW)
    got = port_config.compose(OVERRIDES, job_name="train", make_run_dir=False, now=NOW)
    assert isinstance(got, port_config.ConfigDict)
    assert got.to_plain() == want.to_plain()
    assert got.patch_size == (32, 16, 8) and got.hydra_path == want.hydra_path
    with pytest.raises(FileNotFoundError, match="config=nope"):
        port_config.compose(["config=nope"], make_run_dir=False)
    with pytest.raises(ValueError, match="key=value"):
        port_config.compose(["bare"], make_run_dir=False)


def test_patch_queue_matches_jax(synthetic_dataset):
    """Same seed, process_index=0, aug on: the same patches in the same order."""
    cfg = port_config.compose([
        "config=unet", f"config.data_path={synthetic_dataset}/train/source",
        f"config.gt_path={synthetic_dataset}/train/label", "config.patch_size=8, 8, 8",
        "config.batch_size=2", "config.samples_per_volume=2", "config.aug=true", "config.seed=3",
    ], make_run_dir=False)
    want = list(jax_pipeline.PatchQueueDataset(cfg, process_index=0))
    got = list(port_pipeline.PatchQueueDataset(cfg))  # process_index defaults to 0
    assert len(got) == len(want) == 3
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape == (2, 8, 8, 8, 1) and gy.shape == (2, 8, 8, 8, 1)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_znormalization_and_nifti_round_trip_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    data = rng.normal(3.0, 2.0, size=(1, 9, 7, 5)).astype(np.float32)
    affine = np.diag([1.0, 1.5, 2.0, 1.0])
    np.testing.assert_array_equal(
        port_transforms.ZNormalization().normalize_array(data),
        jax_transforms.ZNormalization().normalize_array(data),
    )
    (tmp_path / "port").mkdir(), (tmp_path / "jax").mkdir()  # gzip stores the file name
    port_io.write_nifti(tmp_path / "port" / "v.nii.gz", port_io.Volume(data, affine))
    jax_io.write_nifti(tmp_path / "jax" / "v.nii.gz", jax_io.Volume(data, affine))
    assert (tmp_path / "port" / "v.nii.gz").read_bytes() == (tmp_path / "jax" / "v.nii.gz").read_bytes()
    back = port_io.read_volume(tmp_path / "port" / "v.nii.gz")
    assert back.data.tobytes() == data.tobytes()
    np.testing.assert_array_equal(back.affine, affine)


def test_logging_copies_work_without_tensorboard_writes(tmp_path):
    meter = AverageMeter()
    meter.update(2.0, 3)
    meter.update(4.0, 1)
    assert meter.val == 4.0 and meter.avg == 2.5 and meter.count == 4
    writer = TBWriter(str(tmp_path))
    writer.add_scalar("Training/Loss", 1.0, 1)
    writer.close()


@pytest.mark.parametrize("platform", [None, "gpu", "cuda", "cpu", "tpu"])
def test_platform_selects_the_device(platform):
    cfg = port_config.ConfigDict(platform=platform)
    assert "platform" not in port_config.TPU_ONLY_KEYS
    if platform == "cpu":
        assert port_config.resolve_device(cfg) == torch.device("cpu")
    elif platform == "tpu":
        with pytest.raises(ValueError, match="platform"):
            port_config.resolve_device(cfg)
    elif torch.cuda.is_available():
        assert port_config.resolve_device(cfg) == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="config.platform=cpu"):
            port_config.resolve_device(cfg)


def test_predict_without_platform_refuses_to_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: predict would run on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_predict.main(["config=unet", f"config.output_dir={tmp_path}", f"config.ckpt={tmp_path}/none.pt"])
