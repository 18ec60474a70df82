"""One train step of SegNet (fixed widths, 32^2 slices, batch 4) in the port against the JAX package's,
dropout off on both sides: in f32 the loss, the BatchNorm running
statistics and the gradients together; in f64 each parameter's gradient
(the bars and why: ``check_train_step`` in
``torch_port_zoo3d.py``).

The f32 step is held to 2e-2 in relative L2 norm, not 1e-2: at this size
the JAX package's own f32 gradients are 1.08e-2 from its f64 ones (1.25e-2
at batch 2, 1.39e-2 at 64^2), as f32 rounding moves the argmax of near-tied
windows in its five masked pools; the port's f32 step measured 1.07e-2.
The f64 leaves keep 1e-6."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_train_step  # noqa: E402


def test_train_step_matches_jax(monkeypatch):
    check_train_step("segnet", monkeypatch, f32_tol=2e-2)
