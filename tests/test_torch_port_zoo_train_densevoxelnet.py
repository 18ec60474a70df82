"""One train step of DenseVoxelNet (fixed widths, 16^3, batch 2) in the port against the JAX package's,
dropout off on both sides: in f32 the loss, the BatchNorm running
statistics and the gradients together; in f64 each parameter's gradient
(the bars and why: ``check_train_step`` in
``torch_port_zoo3d.py``).
Its loss reads the auxiliary y2: the second dense block and the main path's
convs get no gradient in either package."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_train_step  # noqa: E402


def test_train_step_matches_jax(monkeypatch):
    check_train_step("densevoxelnet", monkeypatch, n=2)
