"""One train step of DeepLabV3 (32^2 slices, batch 4, so that ASPP's
global-pool BatchNorm sees 4 values a channel) in the port against the
JAX package's, dropout off on both sides: in f32 the loss, the BatchNorm
running statistics and the gradients together; in f64 each parameter's
gradient (the bars and why: ``check_train_step`` in
``torch_port_zoo3d.py``).

The step runs a shallow backbone on both sides, ``ResNetBackbone`` with
``layers`` (1, 1, 2, 1) (the JAX class takes the argument; its default
dilation, the deep stem and ASPP unchanged; 24.8M parameters), while the
eval logits and the converted checkpoint
(``test_torch_port_zoo2d_deeplab.py``) run at full depth. At full depth
(3, 4, 23, 3) the step is too badly conditioned in f32 for a bar to mean
anything: the JAX package's own f32 gradients sit 8.9e-2 from its f64
ones over all parameters and up to 0.116 on one leaf (the port's f32:
9.1e-2), while the f64 leaves of the two packages agree to 8.6e-7. At the
shallow depth the JAX f32 gradients sit 1.3e-2 from f64, the port's
3.8e-3 (under the 1e-2 bar), and the f64 leaves agree to 6.1e-7
(measured on an x86 CPU)."""

from typing import Sequence

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from general_medical_image_segmentation_cnn_framework_tpu.models.two_d import deeplab  # noqa: E402
from torch_port_zoo3d import check_train_step  # noqa: E402


class ResNetBackbone(deeplab.ResNetBackbone):
    """The JAX ``ResNetBackbone`` with ``layers`` (1, 1, 2, 1) by default:
    the one ``DeepLabV3`` builds while the test patches it in (Flax names
    the scope by the class's name, ``ResNetBackbone_0``, as the port reads it)."""

    layers: Sequence[int] = (1, 1, 2, 1)


def test_train_step_matches_jax(monkeypatch):
    monkeypatch.setattr(deeplab, "ResNetBackbone", ResNetBackbone)
    check_train_step("deeplab_shallow", monkeypatch)
