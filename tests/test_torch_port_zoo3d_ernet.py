"""ER-Net and RE-Net of the port against the JAX package's (fixed widths,
16^3, f32 on the CPU): eval logits after ``convert.py``, converted JAX
checkpoints (weights alone; FusionNet's too, whose logits are in
``test_torch_port_zoo3d_blocks.py``), and ``build_model`` with the JAX
parameter counts."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry  # noqa: E402


@pytest.mark.parametrize("case", ("er_net", "re_net"))
def test_eval_logits_match_jax(case):
    check_eval_logits(case)


@pytest.mark.parametrize("case, with_adam", [("er_net", False), ("re_net", False), ("fusionnet", False)])
def test_jax_checkpoint_converts(case, with_adam, tmp_path):
    check_checkpoint_converts(case, tmp_path, with_adam)


@pytest.mark.parametrize("network", ("er_net", "re_net"))
def test_registry_builds_at_the_jax_width(network):
    check_registry(network)
