"""V-Net of the port against the JAX package's (fixed widths, 16^3, f32 on the
CPU): eval logits after ``convert.py`` (the JAX side on XLA's native conv
route, which compiles faster than the tap-grouped route of its k5 convs),
a converted JAX checkpoint of its 45.6M parameters (weights alone), and
``build_model`` with the JAX parameter count."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry  # noqa: E402


def test_eval_logits_match_jax():
    check_eval_logits("vnet", native=True)


@pytest.mark.parametrize("case, with_adam", [("vnet", False)])
def test_jax_checkpoint_converts(case, with_adam, tmp_path):
    check_checkpoint_converts(case, tmp_path, with_adam)


@pytest.mark.parametrize("network", ("vnet",))
def test_registry_builds_at_the_jax_width(network):
    check_registry(network)
