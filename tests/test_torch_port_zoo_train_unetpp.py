"""One train step of UNet++ (fixed widths, 32^2 slices, batch 4) in the port against the JAX package's,
dropout off on both sides: in f32 the loss, the BatchNorm running
statistics and the gradients together; in f64 each parameter's gradient
(the bars and why: ``check_train_step`` in
``torch_port_zoo3d.py``).

The f32 step is held to 2e-2 in relative L2 norm, not 1e-2: at this size
(ResNet-34's last stage at 1^2, BatchNorm over 4 values a channel) the
JAX package's own f32 gradients are 1.62e-2 from its f64 ones; the port's
f32 step measured 1.29e-2. The f64 leaves keep 1e-6. The running
statistics are held within rtol 1e-5, atol 1e-5 (not 1e-6): the f32 sums
of the 256-input 1x1 projection of the last stage leave its BatchNorm's
batch means up to 1.4e-6 from the f64 step's."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_train_step  # noqa: E402


def test_train_step_matches_jax(monkeypatch):
    check_train_step("unetpp", monkeypatch, stats_tol=(1e-5, 1e-5), f32_tol=2e-2)
