"""PSPNet (its fixed ResNet-34 widths; 32^2 slices, where the pyramid's
6x6 prior is resized down to the 4x4 features) of the port against the JAX
package's on the CPU: eval log-probabilities through ``models.make_forward``'s
2-D adapter after ``convert.py``, a converted checkpoint with Adam,
``build_model`` with the JAX parameter count (27,494,341), and one train
step at batch 4 with the binary BCE on the log-softmax output, as both
train loops apply it (in f32 the loss, the BatchNorm running statistics
and the gradients together within 1e-2; in f64 each parameter's gradient
within 1e-6: ``check_train_step`` in ``torch_port_zoo3d.py``)."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry, check_train_step  # noqa: E402


def test_eval_logits_match_jax():
    check_eval_logits("pspnet", native=True)


def test_jax_checkpoint_with_adam_converts(tmp_path):
    check_checkpoint_converts("pspnet", tmp_path, with_adam=True)


def test_registry_builds_at_the_jax_width():
    check_registry("pspnet")


def test_train_step_matches_jax(monkeypatch):
    check_train_step("pspnet", monkeypatch)
