"""UNETR of the port against the JAX package's (f32 on the CPU, at the JAX
tests' narrow width: embed 32, 4 heads, 12 layers, 32^3, whose 16^3
patches give 2^3 tokens; ``torch_port_zoo3d.py``'s helpers): eval logits
after ``convert.py``, a JAX msgpack checkpoint converted (every tensor one
to one) and served by the port's ``Predictor`` with the JAX model's mask,
and the refusal of any other input shape (the position embeddings fix it),
which the JAX model shares. The decoder's widths are fixed (512 to 64), so
this UNETR has 66.6M parameters: its checkpoint is written without an
optimizer state (VT-UNet's test converts Adam's moments). The blocks:
``test_torch_port_attention.py``; the train step:
``test_torch_port_zoo3d_train_unetr.py``."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_port_zoo3d import (  # noqa: E402
    check_converted_predict, check_eval_logits, jax_model, port_model,
)

from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.serving import Predictor  # noqa: E402


def test_eval_logits_match_jax():
    check_eval_logits("unetr")


def test_converted_checkpoint_predicts_the_jax_mask(tmp_path):
    """Every weight (the position embeddings, the 12 blocks' LayerNorms and
    Denses, the 17 ConvBNReLU convs and statistics) and the mask."""
    raw = np.random.default_rng(21).normal(2.0, 1.5, size=(1, 32, 32, 32)).astype(np.float32)
    share = check_converted_predict("unetr", tmp_path, raw)
    assert 0 < share < 1  # both classes present


def test_other_shapes_are_refused_as_in_jax():
    """A 48^3 input (the whole volume of a 40^3 scan padded to UNETR's
    multiple of 16): the JAX model cannot reshape its 27 tokens to the 8
    position embeddings, and the port refuses it naming the cause, also
    through a whole-volume ``Predictor``."""
    module, variables = jax_model("unetr")
    with pytest.raises(TypeError):
        jax.eval_shape(lambda x: module.apply(variables, x, train=False), jnp.zeros((1, 48, 48, 48, 1)))
    model = port_model("unetr", variables).eval()
    with pytest.raises(ValueError, match="position_embeddings fix its input to img_shape"):
        model(torch.zeros(1, 48, 48, 48, 1))
    cfg = ConfigDict(network="unetr", in_classes=1, out_classes=2, patch_size=(32, 32, 32), patch_overlap=(4, 4, 4),
                     batch_size=1, precision="float32", platform="cpu", whole_volume=True)
    predictor = Predictor(cfg, model=model, params=model.state_dict())
    with pytest.raises(ValueError, match="position_embeddings"):
        predictor.predict_array(np.zeros((1, 40, 40, 40), np.float32))
