"""FCN3D (fixed widths, 24^3: the least size its k7 VALID head and crops
allow, f32 on the CPU) of the port against the JAX package's: eval logits
after ``convert.py`` (its ``_BilinearDeconv`` kernels, a bare ``kernel`` in
each scope, carried too), a converted JAX checkpoint with an Adam state,
and ``build_model`` with the JAX parameter count."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry  # noqa: E402


def test_eval_logits_match_jax():
    check_eval_logits("fcn3d")


def test_jax_checkpoint_with_adam_converts(tmp_path):
    check_checkpoint_converts("fcn3d", tmp_path, with_adam=True)


def test_registry_builds_at_the_jax_width():
    check_registry("fcn3d")
