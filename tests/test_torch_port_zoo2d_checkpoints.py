"""Converted JAX checkpoints with an Adam state of HighRes2DNet, SegNet and
UNet++ (fixed widths; SegNet's 29.4M and UNet++'s 26.9M parameters with
their moments) load into the port: every weight, statistic and moment one
to one (``torch_port_zoo3d.check_checkpoint_converts``)."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from torch_port_zoo3d import check_checkpoint_converts  # noqa: E402


@pytest.mark.parametrize("case", ("highres2dnet", "segnet", "unetpp"))
def test_jax_checkpoint_with_adam_converts(case, tmp_path):
    check_checkpoint_converts(case, tmp_path, with_adam=True)
