"""One train step of IS (init_features 4, 16^3, batch 4) in the port against the JAX package's,
dropout off on both sides: in f32 the loss, the BatchNorm running
statistics and the gradients together; in f64 each parameter's gradient
(the bars and why: ``check_train_step`` in
``torch_port_zoo3d.py``).
IS's shared encoder moves its statistics three times a step: x, then its
low and high bands. They are held to rtol 1e-4, atol 1e-5: on the low band
(constant over H and W at 16^2) the JAX package's f32 batch statistics
leave the first ConvBlock's output 1.6e-3 from its f64 value, the port's
2e-6."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_train_step  # noqa: E402


def test_train_step_matches_jax(monkeypatch):
    check_train_step("IS", monkeypatch)
