"""VT-UNet of the port against the JAX package's (f32 on the CPU, at the
JAX tests' narrow width: embed 12, window 4, 32^3;
``torch_port_zoo3d.py``'s helpers): eval logits after ``convert.py``
(every stage's window clamps on H and W but D, the unshifted last stage,
the bias tables sliced for the clamped windows), a JAX msgpack checkpoint
with an Adam state converted and loaded, the checkpoint served by the
port's ``Predictor`` with the JAX model's mask, an input whose H and W are
not multiples of the patch (the patch embed pads, and the output lives at
the padded size, as in JAX), and the whole-volume ``Predictor`` at
VT-UNet's multiple of 32 with the JAX model's mask. The blocks:
``test_torch_port_attention.py``; the train step:
``test_torch_port_zoo3d_train_vtnet.py``; the export:
``test_torch_port_zoo3d_vtnet_export.py``."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

import jax.numpy as jnp  # noqa: E402
from torch_port_zoo3d import (  # noqa: E402
    assert_mask_of, check_checkpoint_converts, check_converted_predict, check_eval_logits, compiled, jax_logits,
    jax_model, port_model,
)

from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.transforms import ZNormalization  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.serving import Predictor  # noqa: E402


def test_eval_logits_match_jax():
    check_eval_logits("vtnet", scaled=True)


def test_jax_checkpoint_converts(tmp_path):
    """Every weight (the bias tables, the LayerNorms, the matmul convs) and Adam's moments."""
    check_checkpoint_converts("vtnet", tmp_path, with_adam=True)


def test_converted_checkpoint_predicts_the_jax_mask(tmp_path):
    raw = np.random.default_rng(22).normal(2.0, 1.5, size=(1, 32, 32, 32)).astype(np.float32)
    share = check_converted_predict("vtnet", tmp_path, raw)
    assert 0 < share < 1  # both classes present


def test_non_divisible_input_pads_as_jax():
    """30 x 29 x 32 (tests/test_zoo.py's case): padded to 32^3 before the
    patch embed, logits at 32^3, equal to JAX's within 2e-4 of their scale."""
    module, variables = jax_model("vtnet")
    x = np.random.default_rng(23).normal(size=(1, 30, 29, 32, 1)).astype(np.float32)
    want = np.asarray(compiled(False, lambda v, x: module.apply(v, x, train=False), variables, jnp.asarray(x))(
        variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = port_model("vtnet", variables).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 32, 32, 32, 2)
    np.testing.assert_allclose(got, want, atol=2e-4 * max(1.0, float(np.abs(want).max())), rtol=1e-3)


def test_whole_volume_predicts_the_jax_mask():
    """A 40 x 36 x 44 volume: the whole-volume Predictor pads it to 64^3
    (VT-UNet's multiple, 32) and gives the JAX model's mask on that padded
    volume (``assert_mask_of``)."""
    _, variables = jax_model("vtnet")
    model = port_model("vtnet", variables)
    params = model.state_dict()
    raw = np.random.default_rng(24).normal(2.0, 1.5, size=(1, 40, 36, 44)).astype(np.float32)
    cfg = ConfigDict(network="vtnet", in_classes=1, out_classes=2, patch_size=(32, 32, 32), batch_size=1,
                     precision="float32", platform="cpu", whole_volume=True)
    whole = Predictor(cfg, model=model, params=params)
    assert whole.wv_pad == 32
    wmask = whole.predict_array(raw)
    padded = np.pad(ZNormalization().normalize_array(raw), [(0, 0), (0, 24), (0, 28), (0, 20)])
    logits = jax_logits("vtnet", variables, padded.transpose(1, 2, 3, 0)[None])
    assert wmask.shape == (1, 40, 36, 44)
    assert_mask_of(wmask, logits[:, :40, :36, :44])
