"""FCN32s (its fixed VGG-16 widths and 4096-wide head; 32^2 slices, maps of
230^2 after the p100 conv) of the port against the JAX package's on the
CPU: eval logits through ``models.make_forward``'s 2-D adapter after
``convert.py`` (the bare ``upscore_kernel`` carried), a converted
checkpoint with Adam (134.3M parameters with their moments: 1.6 GB each
way, deleted before the test returns), and ``build_model`` with the JAX
parameter count (134,283,970). Its train step:
``test_torch_port_zoo2d_train_fcn2d.py``."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry  # noqa: E402


def test_eval_logits_match_jax():
    check_eval_logits("fcn2d", native=True)


def test_jax_checkpoint_with_adam_converts(tmp_path):
    check_checkpoint_converts("fcn2d", tmp_path, with_adam=True)


def test_registry_builds_at_the_jax_width():
    check_registry("fcn2d")
