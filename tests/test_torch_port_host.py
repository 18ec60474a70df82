"""The port's own copies of the JAX package's host modules and offline
tools against the originals on the same inputs, and the device that ``config.platform``
selects (null, gpu or cuda: the card, raising without one; cpu: the CPU)."""

import datetime
import gzip

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("jax")  # the JAX package is this file's oracle: without JAX the file skips

from general_medical_image_segmentation_cnn_framework_tpu import config as jax_config
from general_medical_image_segmentation_cnn_framework_tpu.data import io as jax_io
from general_medical_image_segmentation_cnn_framework_tpu.data import pipeline as jax_pipeline
from general_medical_image_segmentation_cnn_framework_tpu.data import transforms as jax_transforms
from general_medical_image_segmentation_cnn_framework_tpu.utils import filters as jax_filters
from general_medical_image_segmentation_cnn_framework_tpu.utils import rename_files as jax_rename
from general_medical_image_segmentation_cnn_framework_tpu.utils import trans2nii as jax_trans2nii
from general_medical_image_segmentation_cnn_framework_tpu_torch import config as port_config
from general_medical_image_segmentation_cnn_framework_tpu_torch import predict as port_predict
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import io as port_io
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import pipeline as port_pipeline
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import transforms as port_transforms
from general_medical_image_segmentation_cnn_framework_tpu_torch.logging_utils import AverageMeter, TBWriter
from general_medical_image_segmentation_cnn_framework_tpu_torch.utils import filters as port_filters
from general_medical_image_segmentation_cnn_framework_tpu_torch.utils import rename_files as port_rename
from general_medical_image_segmentation_cnn_framework_tpu_torch.utils import trans2nii as port_trans2nii

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
    got, want = (tmp_path / "port" / "v.nii.gz").read_bytes(), (tmp_path / "jax" / "v.nii.gz").read_bytes()
    # the same file byte for byte but for the gzip header's bytes 4-7, the time of the write
    assert gzip.decompress(got) == gzip.decompress(want)
    assert got[:4] + got[8:] == want[:4] + want[8:]
    back = port_io.read_volume(tmp_path / "port" / "v.nii.gz")
    assert back.data.tobytes() == data.tobytes()
    np.testing.assert_array_equal(back.affine, affine)


@pytest.mark.parametrize("mode", ["crop", "average"])
def test_grid_aggregator_matches_jax(mode):
    """Tiles of a 13x11x9 grid (patch 6,5,4, overlap 2,1,2) added in two
    batches: the same output, dtype and all, in both overlap modes."""
    spatial, patch, overlap = (13, 11, 9), (6, 5, 4), (2, 1, 2)
    locations = port_pipeline.grid_locations(spatial, patch, overlap)
    np.testing.assert_array_equal(locations, jax_pipeline.grid_locations(spatial, patch, overlap))
    tiles = np.random.default_rng(5).integers(0, 3, size=(len(locations), 2, *patch)).astype(np.int32)
    outputs = []
    for module in (port_pipeline, jax_pipeline):
        agg = module.GridAggregator(spatial, overlap, overlap_mode=mode, num_channels=2, dtype=np.int32)
        for b in (slice(0, 7), slice(7, None)):
            agg.add_batch(tiles[b], locations[b])
        outputs.append(agg.get_output_tensor())
    got, want = outputs
    assert got.dtype == want.dtype and got.shape == want.shape == (2, *spatial)
    np.testing.assert_array_equal(got, want)


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


@pytest.mark.parametrize("name", ["gaussian_low_pass", "gaussian_high_pass"])
def test_filters_match_jax(name):
    image = np.random.default_rng(7).normal(size=(12, 10, 8)).astype(np.float32)
    got, want = getattr(port_filters, name)(image, sigma=1.5), getattr(jax_filters, name)(image, sigma=1.5)
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_rename_predictions_matches_jax(tmp_path, capsys):
    """The same renames (printed and on disk) and count; other files stay."""
    runs = {}
    for side, module in (("jax", jax_rename), ("port", port_rename)):
        root = tmp_path / side
        root.mkdir()
        for name in ("pred-0000.nii.gz", "pred-0012.nii.gz", "pred-0003.mhd", "metrics.csv"):
            (root / name).write_text(name)
        count = module.rename_predictions(root, offset=5)
        runs[side] = (count, capsys.readouterr().out, {p.name: p.read_text() for p in root.iterdir()})
    assert runs["port"] == runs["jax"] and runs["port"][0] == 2


def test_convert_mhd_to_nii_matches_jax(tmp_path):
    """The same NIfTI files, byte for byte once gunzipped (the gzip header
    holds the time of the write), from the same MHD volumes."""
    src = tmp_path / "mhd"
    src.mkdir()
    rng = np.random.default_rng(8)
    for i in range(2):
        jax_io.write_mhd(src / f"case-{i}.mhd", jax_io.Volume(rng.normal(size=(1, 6, 7, 5)).astype(np.float32),
                                                            np.diag([0.8, 1.0, 2.5, 1.0])))
    assert port_trans2nii.convert_mhd_to_nii(src, tmp_path / "port") == 2
    assert jax_trans2nii.convert_mhd_to_nii(src, tmp_path / "jax") == 2
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["case-0.nii.gz", "case-1.nii.gz"]
    for name in names:
        assert gzip.decompress((tmp_path / "port" / name).read_bytes()) == \
            gzip.decompress((tmp_path / "jax" / name).read_bytes())
