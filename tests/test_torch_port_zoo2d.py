"""HighRes2DNet, SegNet and UNet++ (fixed widths, 32^2 slices, f32 on the
CPU) of the port against the JAX package's: eval logits through
``models.make_forward``'s 2-D adapter after ``convert.py`` (UNet++'s
``mix`` carried too), and ``build_model`` with the JAX parameter counts.
The JAX side compiles at XLA's default optimisation level: at level 0
SegNet's compiled logits are up to 0.12 from the uncompiled (and the
default-level) JAX model's, which the port matches within 4e-7."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_eval_logits, check_registry  # noqa: E402

CASES = ("highres2dnet", "segnet", "unetpp")


@pytest.mark.parametrize("case", CASES)
def test_eval_logits_match_jax(case):
    check_eval_logits(case, native=True)


@pytest.mark.parametrize("network", CASES)
def test_registry_builds_at_the_jax_width(network):
    check_registry(network)
