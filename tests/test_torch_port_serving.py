"""The port's serving layer (``serving.Predictor``, ``serve``) against the
JAX package's on the same weights, f32 on the CPU: UNet3D at
init_features=4 with the JAX weights carried over by ``convert.py``, and
24x24x16 raw volumes from a numpy seed, as ``tests/test_serving.py`` uses.
The masks are equal byte for byte."""

import gzip
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from general_medical_image_segmentation_cnn_framework_tpu import models as jax_models
from general_medical_image_segmentation_cnn_framework_tpu import serving as jax_serving
from general_medical_image_segmentation_cnn_framework_tpu.checkpoint import save_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu.config import compose as jax_compose
from general_medical_image_segmentation_cnn_framework_tpu.data.io import Volume, write_nifti
from general_medical_image_segmentation_cnn_framework_tpu_torch import models as port_models
from general_medical_image_segmentation_cnn_framework_tpu_torch import serving
from general_medical_image_segmentation_cnn_framework_tpu_torch.checkpoint import save_checkpoint as port_save
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import (
    convert_checkpoint,
    state_dict_from_flax,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from test_torch_port_unet3d import jax_unet

BASE = [
    "config=unet",
    "config.patch_size=16, 16, 16",
    "config.batch_size=2",
    "config.precision=float32",
    "config.patch_overlap=4, 4, 4",
]


def raw_volume(shape=(24, 24, 16), seed=3):
    r = np.random.default_rng(seed)
    return r.normal(0.5, 1.2, (1, *shape)).astype(np.float32)


def nifti_bytes(path) -> bytes:
    """A .nii.gz file's NIfTI bytes (its gzip header holds a file name and a
    time, which differ between two writes)."""
    return gzip.decompress(path.read_bytes())


def configs(tmp_path, *options):
    """The JAX config and the port's (on the CPU) for the same options."""
    jax_cfg = jax_compose([*BASE, f"config.output_dir={tmp_path / 'jax'}", *options], job_name="serve")
    port_cfg = compose([*BASE, f"config.output_dir={tmp_path / 'port'}", "config.platform=cpu", *options],
                       job_name="serve")
    return jax_cfg, port_cfg


@pytest.fixture(scope="module")
def weights():
    """The f=4 UNet3D's seeded weights: the Flax model and variables, and
    the port's state dict of the same weights."""
    model, variables = jax_unet(4, seed=17)
    return model, variables, state_dict_from_flax(variables["params"], variables["batch_stats"])


@pytest.fixture(scope="module")
def checkpoints(weights, tmp_path_factory):
    _, variables, _ = weights
    root = tmp_path_factory.mktemp("ckpt")
    jax_ckpt, port_ckpt = root / "latest_checkpoint.ckpt", root / "unet3d.pt"
    save_checkpoint(jax_ckpt, variables["params"], variables["batch_stats"], {}, epoch=1)
    convert_checkpoint(jax_ckpt, port_ckpt)
    return jax_ckpt, port_ckpt


def predictors(weights, tmp_path, *options):
    model, variables, state = weights
    jax_cfg, port_cfg = configs(tmp_path, *options)
    return (jax_serving.Predictor(jax_cfg, model=model, variables=variables),
            serving.Predictor(port_cfg, model=UNet3D(1, 2, 4), params=state))


@pytest.mark.parametrize("options", [
    (),
    ("config.whole_volume=true",),
    ("config.shape_bucket=32",),
    ("config.tta=flips",),
    ("config.patch_overlap=null",),
], ids=["crop", "whole_volume", "shape_bucket", "tta", "overlap_unset"])
def test_predict_array_matches_jax(options, weights, tmp_path):
    """``Predictor.predict_array``: the JAX mask byte for byte (int32
    [1, X, Y, Z], not constant); an unset ``patch_overlap`` is half the
    patch in both."""
    jax_pred, port_pred = predictors(weights, tmp_path, *options)
    assert port_pred.overlap == jax_pred.overlap
    assert port_pred.whole_volume == jax_pred.whole_volume and port_pred.wv_pad == jax_pred.wv_pad
    src = raw_volume()
    want = np.asarray(jax_pred.predict_array(src))
    got = port_pred.predict_array(src)
    assert got.shape == want.shape == (1, 24, 24, 16) and got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()
    assert 0 < got.mean() < 1


def test_thunk_and_predict_file_match(weights, tmp_path):
    """``sync=False`` gives a thunk of the synced mask and calls
    ``on_dispatch`` once; ``predict_file`` writes the NIfTI bytes JAX
    writes."""
    jax_pred, port_pred = predictors(weights, tmp_path)
    src = raw_volume(seed=5)
    calls = []
    thunk = port_pred.predict_array(src, sync=False, on_dispatch=lambda: calls.append(1))
    assert callable(thunk) and calls == [1]
    assert thunk().tobytes() == port_pred.predict_array(src).tobytes()

    affine = np.diag([1.0, 1.5, 2.0, 1.0])
    write_nifti(tmp_path / "case.nii.gz", Volume(src, affine))
    jax_pred.predict_file(tmp_path / "case.nii.gz", tmp_path / "jax.nii.gz")
    mask = port_pred.predict_file(tmp_path / "case.nii.gz", tmp_path / "port.nii.gz")
    assert mask.shape == (1, 24, 24, 16)
    assert nifti_bytes(tmp_path / "port.nii.gz") == nifti_bytes(tmp_path / "jax.nii.gz")


def test_serve_once_matches_jax_and_restarts_idle(weights, checkpoints, tmp_path, monkeypatch):
    """``serve(once=True)`` over a watch directory: the names and mask files
    of the JAX ``serve``; a file of another suffix is left alone; a restart
    finds every mask written and returns ``{}``."""
    model = weights[0]
    jax_ckpt, port_ckpt = checkpoints
    monkeypatch.setattr(jax_models, "build_model", lambda config: model)
    monkeypatch.setattr(port_models, "build_model", lambda config: UNet3D(1, 2, 4))
    watch = tmp_path / "incoming"
    watch.mkdir()
    for i in range(2):
        write_nifti(watch / f"case-{i}.nii.gz", Volume(raw_volume(seed=10 + i)))
    (watch / "notes.txt").write_text("not a volume")
    jax_cfg, port_cfg = configs(tmp_path, f"config.watch_dir={watch}")
    jax_cfg.ckpt, port_cfg.ckpt = str(jax_ckpt), str(port_ckpt)

    want = jax_serving.serve(jax_cfg, once=True)
    got = serving.serve(port_cfg, once=True)
    assert sorted(got) == sorted(want) == ["case-0.nii.gz", "case-1.nii.gz"]
    for name, path in got.items():
        assert path.endswith(f"pred_file/pred-{name[:-len('.nii.gz')]}.nii.gz")
        assert nifti_bytes(Path(path)) == nifti_bytes(Path(want[name]))
    assert serving.serve(port_cfg, once=True) == {}


def test_wrong_network_and_no_card_raise(weights, tmp_path):
    """A checkpoint of another network raises the ``ValueError`` naming the
    network; without ``platform=cpu`` and without a card the Predictor
    raises instead of running on the CPU."""
    wide = tmp_path / "unet3d_f8.pt"
    port_save(wide, UNet3D(1, 2, 8).state_dict(), epoch=0)
    _, port_cfg = configs(tmp_path)
    port_cfg.ckpt = str(wide)
    with pytest.raises(ValueError, match="does not match network 'unet'"):
        serving.Predictor(port_cfg, model=UNet3D(1, 2, 4))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the Predictor would run on it")
    card_cfg = compose([*BASE, f"config.output_dir={tmp_path / 'card'}"], job_name="serve", make_run_dir=False)
    with pytest.raises(RuntimeError, match="config.platform=cpu"):
        serving.Predictor(card_cfg, model=UNet3D(1, 2, 4), params=weights[2])
