"""The port's ``predict.main`` with ``whole_volume`` and ``shape_bucket``
against JAX ``predict.predict`` on the same weights (as
``test_torch_port_predict_cli_options.py``), and the pipelined loop's
threads: an exception in the loader or in a writer reaches the caller, and
no thread outlives the call."""

import threading

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from general_medical_image_segmentation_cnn_framework_tpu.data.io import read_volume
from general_medical_image_segmentation_cnn_framework_tpu_torch import predict as port_predict
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from test_torch_port_predict_cli_options import _overrides, checkpoints, run_both  # noqa: F401 (a fixture)


@pytest.mark.parametrize("options", [
    ("config.whole_volume=true",),
    ("config.shape_bucket=24",),
], ids=lambda o: "+".join(v.split(".", 1)[1] for v in o))
def test_predict_option_matches_jax(options, checkpoints, synthetic_dataset, tmp_path, monkeypatch):
    """Masks and ``metrics.csv`` byte for byte, for one whole-volume forward
    and for a bucket of 24 (the 32^3 volumes padded to 48^3 on the device,
    the grid and crop on the true extent)."""
    run_both(*checkpoints, synthetic_dataset / "test", tmp_path, options, monkeypatch)


@pytest.mark.parametrize("fault", ["loader", "writer"])
def test_a_fault_reaches_the_caller_and_no_thread_outlives_predict(fault, checkpoints, synthetic_dataset, tmp_path,
                                                                  monkeypatch):
    """Three volumes, the second a corrupt .nii.gz (the loader's read
    fails), or a mask write that fails in a worker: ``predict.main`` raises
    that error, and every thread it started has ended when it returns."""
    _, _, port_ckpt = checkpoints
    data = tmp_path / "data"
    for split in ("source", "label"):
        (data / split).mkdir(parents=True)
        for i in range(3):
            src = synthetic_dataset / "test" / split / f"vol-{i % 2:02d}.nii.gz"
            (data / split / f"vol-{i:02d}.nii.gz").write_bytes(src.read_bytes())
    if fault == "loader":
        (data / "source" / "vol-01.nii.gz").write_bytes(b"\x1f\x8b\x08\x00 not a volume")
        with pytest.raises(Exception) as direct:
            read_volume(data / "source" / "vol-01.nii.gz")
        error = type(direct.value)
    else:
        error = RuntimeError

        def failing_write(pred, affine, index, config):
            raise RuntimeError(f"cannot write mask {index}")

        monkeypatch.setattr(port_predict, "save_pred", failing_write)
    monkeypatch.setattr(port_predict, "build_model", lambda config: UNet3D(1, 2, 4))
    before = set(threading.enumerate())
    with pytest.raises(error):
        port_predict.main(_overrides(data, tmp_path / "port", port_ckpt, "config.platform=cpu"))
    assert [t for t in threading.enumerate() if t not in before] == []


def test_whole_volume_on_a_2d_network_warns_and_runs_the_sliding_window(synthetic_dataset, tmp_path):
    """``config=unet2d`` with ``whole_volume=true``: the JAX package's warning,
    word for word, in the run's log, then the sliding window's masks and
    ``metrics.csv``, the same as without the option."""
    import torch

    from general_medical_image_segmentation_cnn_framework_tpu_torch.checkpoint import save_checkpoint
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.two_d.unet2d import UNet2D

    ckpt = tmp_path / "unet2d.pt"
    torch.manual_seed(0)
    save_checkpoint(ckpt, UNet2D(1, 2).state_dict(), epoch=0)
    data = synthetic_dataset / "test"
    args = ["config=unet2d", "config.platform=cpu", "config.precision=float32", f"config.ckpt={ckpt}",
            f"config.pred_data_path={data}/source", f"config.pred_gt_path={data}/label",
            "config.patch_size=1, 32, 32", "config.patch_overlap=4, 4, 4", "config.batch_size=8"]
    port_predict.main(args + [f"config.output_dir={tmp_path / 'plain'}"])
    port_predict.main(args + [f"config.output_dir={tmp_path / 'wv'}", "config.whole_volume=true"])
    (plain,), (wv,) = (tmp_path / "plain").glob("predict-*/*"), (tmp_path / "wv").glob("predict-*/*")
    assert ("whole_volume is 3-D only; 'unet2d' is a 2-D network — falling back to sliding-window prediction"
            in (wv / "predict.log").read_text())
    assert "whole_volume is 3-D only" not in (plain / "predict.log").read_text()
    for name in ("pred-0000.nii.gz", "pred-0001.nii.gz"):  # the gzip header holds a time: compare the volumes
        got, want = read_volume(wv / "pred_file" / name), read_volume(plain / "pred_file" / name)
        assert got.data.tobytes() == want.data.tobytes() and got.data.shape == (1, 32, 32, 32)
    assert (wv / "metrics.csv").read_bytes() == (plain / "metrics.csv").read_bytes()
