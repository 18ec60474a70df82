"""MiniSeg (its fixed widths, 8 to 64; 32^2 slices) of the port against
the JAX package's on the CPU: eval logits through ``models.make_forward``'s
2-D adapter after ``convert.py``, a converted checkpoint with Adam,
``build_model`` with the JAX parameter count (99,146), and one train step
at batch 4 (in f32 the loss, the BatchNorm running statistics and the
gradients together within 1e-2; in f64 each parameter's gradient within
1e-6: ``check_train_step`` in ``torch_port_zoo3d.py``).

The eval logits are held within atol 2e-4 of their largest magnitude, not
2e-4 outright: with the seeded BatchNorm statistics (which do not
normalise this input) MiniSeg's residual sums over its levels grow the
logits to 1.7e5, where f32 rounding alone leaves values near 0 up to 0.4
apart (2.4e-6 of the scale, measured on an x86 CPU)."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry, check_train_step  # noqa: E402


def test_eval_logits_match_jax():
    check_eval_logits("miniseg", native=True, scaled=True)


def test_jax_checkpoint_with_adam_converts(tmp_path):
    check_checkpoint_converts("miniseg", tmp_path, with_adam=True)


def test_registry_builds_at_the_jax_width():
    check_registry("miniseg")


def test_train_step_matches_jax(monkeypatch):
    check_train_step("miniseg", monkeypatch)
