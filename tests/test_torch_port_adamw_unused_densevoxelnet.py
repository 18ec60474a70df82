"""One ``optimizer=adamw weight_decay=0.01`` train step of DenseVoxelNet
(16^3, batch 2, f32 on the CPU, dropout off on both sides) in the port
against the JAX package's: the network returns its auxiliary y2, so the
second dense block and the main path's 1x1 conv, BatchNorm and up-convs
get no gradient.

``jax.grad`` gives a parameter that does not reach the loss a zero
gradient and optax updates every leaf, so AdamW's decay shrinks those
kernels by 1 - lr * wd and leaves their 1-D tensors as they were; the
port's step must do the same (torch's optimizers skip a parameter whose
``grad`` is None). Those parameters are held within 1e-6 relative of JAX's
(an untouched kernel is 1e-5 off); the rest, whose AdamW step is about lr
times the sign of a gradient that f32 rounding moves where it is near 0,
within 2 lr; every parameter's Adam step count is 1, as optax's one
``count`` (``torch_port_zoo3d.check_adamw_unused``)."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_adamw_unused  # noqa: E402


def test_adamw_decays_the_parameters_without_a_gradient_as_jax(monkeypatch):
    check_adamw_unused("densevoxelnet", monkeypatch)
