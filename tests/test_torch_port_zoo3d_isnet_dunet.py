"""IS (init_features 4) and Double U-Net (8) of the port against the JAX
package's at 16^3, f32 on the CPU: eval logits after ``convert.py`` (IS
through its FFT bands), converted JAX checkpoints (IS's with an Adam
state: its one encoder, used three times, is one set of weights and of
moments; Double U-Net's weights alone), and ``build_model`` with the JAX
parameter counts (FusionNet's too)."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry  # noqa: E402


@pytest.mark.parametrize("case", ("IS", "dunet"))
def test_eval_logits_match_jax(case):
    check_eval_logits(case)


@pytest.mark.parametrize("case, with_adam", [("IS", True), ("dunet", False)])
def test_jax_checkpoint_converts(case, with_adam, tmp_path):
    check_checkpoint_converts(case, tmp_path, with_adam)


@pytest.mark.parametrize("network", ("IS", "dunet", "fusionnet"))
def test_registry_builds_at_the_jax_width(network):
    check_registry(network)
