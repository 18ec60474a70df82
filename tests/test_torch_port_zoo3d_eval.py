"""res_unet, HighResNet and CSR-Net of the port against the JAX package's
(f32 on the CPU, ``torch_port_zoo3d.py``'s widths and helpers): eval
logits through ``models.make_forward`` after ``convert.py``, JAX msgpack
checkpoints converted and loaded (res_unet's with an Adam state), and
``build_model`` at the JAX ``from_config`` width with the JAX parameter
count."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry  # noqa: E402

CASES = ("res_unet", "highresnet", "csrnet")


@pytest.mark.parametrize("case", CASES)
def test_eval_logits_match_jax(case):
    check_eval_logits(case)


@pytest.mark.parametrize("case, with_adam", [("csrnet", False), ("res_unet", True), ("highresnet", False)])
def test_jax_checkpoint_converts(case, with_adam, tmp_path):
    """CSR-Net's and HighResNet's weights; res_unet's with an Adam state
    (its shared convs are one parameter each, with one moment)."""
    check_checkpoint_converts(case, tmp_path, with_adam)


@pytest.mark.parametrize("network", CASES)
def test_registry_builds_at_the_jax_width(network):
    check_registry(network)
