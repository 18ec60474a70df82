"""One train step of VT-UNet (embed 12, window 4, 32^3, batch 4) in the
port against the JAX package's, dropout and DropPath off on both sides: in
f32 the loss and the gradients together; in f64 each parameter's gradient
within 1e-6, the relative position bias tables among them (the bars and
why: ``check_train_step`` in ``torch_port_zoo3d.py``). The JAX step
compiles at XLA's backend optimisation level 0 (``FAST_STEP``): VT-UNet
has no conv, and its default-level compile takes 36 s on one core."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_train_step  # noqa: E402


def test_train_step_matches_jax(monkeypatch):
    distance = check_train_step("vtnet", monkeypatch)
    # the bias tables of the 7 encoder and 6 decoder blocks
    assert sum(1 for k in distance if k.endswith("relative_position_bias_table")) == 13
