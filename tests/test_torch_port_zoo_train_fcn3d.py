"""One train step of FCN3D (fixed widths, 24^3, batch 1) in the port against the JAX package's,
dropout off on both sides: in f32 the loss, the BatchNorm running
statistics and the gradients together; in f64 each parameter's gradient
(the bars and why: ``check_train_step`` in
``torch_port_zoo3d.py``).
FCN3D has no BatchNorm, so batch 1 holds the whole step. This file takes
minutes on one core, not seconds: the p60 stem makes 142^3 x 8 maps of
the 24^3 input, and the k3 convs at 142^3 and 99^3 cost both packages'
f64 steps about 100 GFLOP on the CPU."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_train_step  # noqa: E402


def test_train_step_matches_jax(monkeypatch):
    check_train_step("fcn3d", monkeypatch, n=1)
