"""The port's export of the predict program (``serving.export_predictor``,
``load_exported_predictor``) against the port's ``Predictor`` and the JAX
package's exported program on the same weights, f32 on the CPU (UNet3D at
init_features=4, a 24x24x16 volume): the same masks, every eval conv in
the graph the registered hand-kernel operator, the JAX meta's keys, a
load with the port's model code blocked, the errors, and ``serving.main``
in its export and ``serve_once`` modes; and ER-Net, a network of bare
``TorchConv``s (no ConvBlock), exported by the whole volume."""

import json
import os
import subprocess
import sys
import zipfile
from collections import Counter
from io import BytesIO
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from general_medical_image_segmentation_cnn_framework_tpu import serving as jax_serving
from general_medical_image_segmentation_cnn_framework_tpu.data.io import Volume, write_nifti
from general_medical_image_segmentation_cnn_framework_tpu_torch import models as port_models
from general_medical_image_segmentation_cnn_framework_tpu_torch import serving
from general_medical_image_segmentation_cnn_framework_tpu_torch.checkpoint import save_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.io import read_volume
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.transforms import ZNormalization
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.er_net import ERNet
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.conv3d_bn_relu import NAMESPACE
from test_torch_port_serving import BASE, predictors, raw_volume, weights  # noqa: F401 (weights: a fixture)

ROOT = Path(__file__).resolve().parents[1]
PORT = "general_medical_image_segmentation_cnn_framework_tpu_torch"
SPATIAL = (24, 24, 16)
EXPORT = ("config.batch_size=3",)  # 4 tiles of 16^3 on the 24x24x16 grid at overlap 4: 2 batches, the last padded
MODES = {"crop": (), "whole_volume": ("config.whole_volume=true",)}


@pytest.fixture(scope="module")
def artifacts(weights, tmp_path_factory):
    """By mode: the port's Predictor and artifact (crop: written by
    ``serving.main``'s export mode from a checkpoint, and loaded from that
    file; whole_volume: the bytes of ``export_predictor``), the artifact
    loaded (with its program and meta), and the JAX
    Predictor and artifact of the same weights."""
    root = tmp_path_factory.mktemp("export")
    ckpt, path = root / "unet3d.pt", root / "crop.pt2"
    save_checkpoint(ckpt, weights[2], epoch=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_models, "build_model", lambda config: UNet3D(1, 2, 4))
        assert serving.main([*BASE, *EXPORT, f"config.output_dir={root / 'runs'}", "config.platform=cpu",
                             f"config.ckpt={ckpt}", f"config.export_path={path}",
                             "config.export_spatial=24, 24, 16"]) is None
    out = {}
    for mode, options in MODES.items():
        jax_pred, port_pred = predictors(weights, root / mode, *EXPORT, *options)
        blob = path.read_bytes() if mode == "crop" else serving.export_predictor(port_pred, SPATIAL)
        out[mode] = dict(
            port_pred=port_pred, blob=blob, path=path if mode == "crop" else None,
            predict=serving.load_exported_predictor(path if mode == "crop" else blob),
            jax_pred=jax_pred, jax_blob=jax_serving.export_predictor(jax_pred, SPATIAL),
        )
    return out


@pytest.mark.parametrize("mode", MODES)
def test_round_trip_matches_predictor_and_jax(mode, artifacts, weights):
    """The crop program from its file and the whole volume's from its bytes:
    the Predictor's mask, and the mask of the JAX package's exported program
    on the same weights."""
    a = artifacts[mode]
    src = raw_volume()
    want = a["port_pred"].predict_array(src)
    volume = ZNormalization().normalize_array(src)
    jax_mask = np.asarray(jax_serving.load_exported_predictor(a["jax_blob"])(a["jax_pred"].variables, volume))
    assert jax_mask.tobytes() == want.tobytes() and 0 < want.mean() < 1
    got = a["predict"](weights[2], volume)
    assert got.shape == (1, *SPATIAL) and got.dtype == np.int32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", MODES)
def test_graph_runs_the_registered_conv(mode, artifacts):
    """The graph calls the registered conv 18 times a forward batch and has
    no convolution of ATen's; the artifact holds no weights."""
    program = artifacts[mode]["predict"].program
    targets = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    assert targets[f"{NAMESPACE}.conv3d_bn_relu.default"] == 18 * (1 if mode == "whole_volume" else 2)
    assert not [t for t in targets if "conv" in t and not t.startswith(NAMESPACE)], targets
    assert not program.state_dict and program.example_inputs is None


@pytest.mark.parametrize("mode", MODES)
def test_meta_matches_jax(mode, artifacts):
    """The JSON meta has the JAX meta's keys and values, but ``pack``
    (false: the port fetches int8) and the added ``device``."""
    meta = artifacts[mode]["predict"].meta
    _, jax_meta = jax_serving._unpack_artifact(artifacts[mode]["jax_blob"])
    jax_meta = json.loads(json.dumps(jax_meta))
    assert set(meta) == set(jax_meta) | {"device"}
    assert meta["pack"] is False and meta["device"] == "cpu"
    assert {k: v for k, v in meta.items() if k not in ("pack", "device")} == \
        {k: v for k, v in jax_meta.items() if k != "pack"}
    assert ("starts" in meta) == (mode == "crop") and ("padded" in meta) == (mode == "whole_volume")


_BLOCKED_LOAD = f"""
import sys
for name in ("jax", "flax", "general_medical_image_segmentation_cnn_framework_tpu", "{PORT}.models", "{PORT}.nn"):
    sys.modules[name] = None
import numpy as np, torch
from {PORT}.serving import load_exported_predictor
predict = load_exported_predictor(sys.argv[1])
np.save(sys.argv[4], predict(torch.load(sys.argv[2]), np.load(sys.argv[3])))
loaded = [m for m in sys.modules if m.startswith(("{PORT}.models", "{PORT}.nn")) and sys.modules[m] is not None]
assert not loaded, loaded
"""


def test_load_with_the_model_code_blocked(artifacts, weights, tmp_path):
    """A process with the port's ``models`` and ``nn`` (and JAX) blocked
    loads the crop artifact and gives the Predictor's mask."""
    src = raw_volume()
    torch.save(weights[2], tmp_path / "params.pt")
    np.save(tmp_path / "volume.npy", ZNormalization().normalize_array(src))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_LOAD, str(artifacts["crop"]["path"]), str(tmp_path / "params.pt"),
         str(tmp_path / "volume.npy"), str(tmp_path / "mask.npy")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    want = artifacts["crop"]["port_pred"].predict_array(src)
    assert np.load(tmp_path / "mask.npy").tobytes() == want.tobytes()


def with_meta(blob: bytes, **changes) -> bytes:
    """The artifact with its meta's entries changed (the zip rewritten)."""
    out = BytesIO()
    with zipfile.ZipFile(BytesIO(blob)) as src, zipfile.ZipFile(out, "w") as dst:
        for info in src.infolist():
            data = src.read(info)
            if info.filename.endswith("/extra/meta.json"):
                data = json.dumps({**json.loads(data), **changes}).encode()
            dst.writestr(info, data)
    return out.getvalue()


@pytest.mark.parametrize("mode", MODES)
def test_errors(mode, artifacts, weights, tmp_path):
    """Another spatial shape fails as the JAX assert does; the sliding
    window exports the crop blend only; an artifact of the card does not
    load without one (faked by editing the meta)."""
    a = artifacts[mode]
    other = ZNormalization().normalize_array(raw_volume(shape=(24, 24, 24)))
    message = r"exported for spatial \(24, 24, 16\), got \(24, 24, 24\)"
    with pytest.raises(ValueError, match=message):
        a["predict"](weights[2], other)
    if mode == "crop":
        with pytest.raises(AssertionError, match=message):
            jax_serving.load_exported_predictor(a["jax_blob"])(a["jax_pred"].variables, other)
        _, blended = predictors(weights, tmp_path, "config.blend=mean_logits")
        with pytest.raises(ValueError, match="mean_logits"):
            serving.export_predictor(blended, SPATIAL)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the artifact would load")
    with pytest.raises(RuntimeError, match="exported on a CUDA card"):
        serving.load_exported_predictor(with_meta(a["blob"], device="cuda"))


def test_main_serves_once(weights, tmp_path, monkeypatch):
    """``serving.main`` in the ``serve_once`` mode with
    ``config.platform=cpu`` writes the Predictor's mask for the volume of
    the watch directory and returns it."""
    monkeypatch.setattr(port_models, "build_model", lambda config: UNet3D(1, 2, 4))
    ckpt = tmp_path / "unet3d.pt"
    save_checkpoint(ckpt, weights[2], epoch=1)
    src = raw_volume()
    watch = tmp_path / "incoming"
    watch.mkdir()
    write_nifti(watch / "case-0.nii.gz", Volume(src))
    done = serving.main([*BASE, f"config.output_dir={tmp_path / 'runs'}", "config.platform=cpu", f"config.ckpt={ckpt}",
                         f"config.watch_dir={watch}", "config.serve_once=true"])
    assert list(done) == ["case-0.nii.gz"]
    mask = read_volume(done["case-0.nii.gz"])
    want = predictors(weights, tmp_path)[1].predict_array(src)
    assert mask.data.dtype == np.float32 and np.array_equal(mask.data, want.astype(np.float32))


def test_bare_torch_conv_network_exports(tmp_path):
    """ER-Net (fixed widths, seeded weights and BatchNorm statistics)
    is built from bare ``TorchConv`` + BatchNorm, whose eval conv is the
    same registered operator as a folded ConvBlock's: its whole-volume
    program on 16^3 exports with its 14 k3 convs as that operator and no
    ATen conv, loads, and gives the Predictor's mask."""
    model = ERNet(2, 1)
    rng = np.random.default_rng(5)

    def draw(name, shape):
        if "running_var" in name or (name.endswith(".weight") and len(shape) == 1):  # BatchNorm's var and scale
            return rng.uniform(0.5, 1.5, shape)
        if len(shape) > 1:  # conv and Dense kernels [..., in, out]
            return rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape)
        return rng.normal(0.0, 0.2, shape)  # biases, BatchNorm shifts and running means

    state = {k: torch.from_numpy(draw(k, tuple(v.shape)).astype(np.float32)) for k, v in model.state_dict().items()}
    config = compose(["config=er_net", "config.patch_size=16, 16, 16", "config.batch_size=1", "config.precision=float32",
                      "config.whole_volume=true", "config.platform=cpu", f"config.output_dir={tmp_path}"],
                     job_name="serve")
    predictor = serving.Predictor(config, model=model, params=state)
    src = raw_volume(shape=(16, 16, 16))
    want = predictor.predict_array(src)
    predict = serving.load_exported_predictor(serving.export_predictor(predictor, (16, 16, 16)))
    targets = Counter(str(n.target) for n in predict.program.graph.nodes if n.op == "call_function")
    assert targets[f"{NAMESPACE}.conv3d_bn_relu.default"] == 14
    assert not [t for t in targets if "conv" in t and not t.startswith(NAMESPACE)], targets
    got = predict(state, ZNormalization().normalize_array(src))
    assert got.shape == (1, 16, 16, 16) and 0 < want.mean() < 1
    assert got.tobytes() == want.tobytes()
