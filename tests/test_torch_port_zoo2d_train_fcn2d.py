"""One train step of FCN32s (its fixed widths, 134.3M parameters; 16^2
slices, its least size, where fc6 sees 1^2; batch 1: it has no
BatchNorm) in the port against the JAX package's, both in f32, dropout off
on both sides: the loss within 1e-5 and every parameter's gradient on its
own within 1e-2 in relative L2 (``check_train_step_f32`` in
``torch_port_zoo3d.py``).

Not in f64 as the other networks' steps: XLA's f64 convs at the 214^2
maps of the p100 first conv take the JAX f64 step 69 s on an 8-core x86 CPU,
against 3.6 s in f32. The bar follows from the JAX package's own f32 step,
whose gradients sit up to 8.8e-3 from its f64 ones on one leaf (the first
conv's kernel; 1.8e-4 at the last conv, 8e-7 in the head): the port's f32
gradients are held to JAX's f32 ones within 1e-2, no further than JAX's
f32 is from its own f64. Measured: 2.4e-4 at worst (the first conv's
bias), 1.6e-6 at the upscore kernel (measured on that CPU)."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_train_step_f32  # noqa: E402


def test_train_step_matches_jax(monkeypatch):
    check_train_step_f32("fcn2d_16", monkeypatch, n=1, leaf_tol=1e-2)
