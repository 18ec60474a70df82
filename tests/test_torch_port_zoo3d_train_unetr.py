"""One train step of UNETR (embed 32, 4 heads, 12 layers; 32 x 16 x 16,
two tokens; batch 1) in the port against the JAX package's, both in f32,
dropout off on both sides: the loss within 1e-5 and every parameter's
gradient on its own within 1e-4 in relative L2, the position embeddings
among them (``check_train_step_f32`` in ``torch_port_zoo3d.py``).

Not in f64 as the other BatchNorm networks' steps: XLA's f64 convs at the
fixed 64-channel decoder's full-size maps take the JAX f64 step 87 s on one
core at this size (635 s at 2 x 32^3), against about 20 s in f32; the port's
own f64 step there agrees with it within 4.2e-8 on every leaf. The bar
follows from the JAX package's own f32 step, whose gradients sit up to
5.7e-6 from its f64 ones on a leaf (a BatchNorm shift); the port's f32
ones are 8.2e-6 from JAX's f64 at worst (a key projection). A gradient that
is 0 but for rounding (the conv biases in front of BatchNorm, the key
biases) is f32 noise of up to 6.5e-8 of the norm of all of them in JAX's
f32 step, so it is held absolute below 1e-6 of that norm
(``zero_floor``). Measured on an x86 CPU, one core."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_train_step_f32  # noqa: E402


def test_train_step_matches_jax(monkeypatch):
    distance = check_train_step_f32("unetr_step", monkeypatch, n=1, leaf_tol=1e-4, zero_floor=1e-6)
    assert "position_embeddings" in distance
