"""DeepLabV3 at full depth (ResNet-101 backbone, ASPP; 32^2 slices) of the
port against the JAX package's on the CPU: eval logits through
``models.make_forward``'s 2-D adapter after ``convert.py`` (the depth read
from the tree), a converted checkpoint with Adam (58.2M parameters with
their moments), and ``build_model`` with the JAX parameter count
(58,158,402). Its train step: ``test_torch_port_zoo2d_train_deeplab.py``."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry  # noqa: E402


def test_eval_logits_match_jax():
    check_eval_logits("deeplab", native=True)


def test_jax_checkpoint_with_adam_converts(tmp_path):
    check_checkpoint_converts("deeplab", tmp_path, with_adam=True)


def test_registry_builds_at_the_jax_width():
    check_registry("deeplab")
