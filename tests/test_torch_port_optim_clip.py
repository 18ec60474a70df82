"""``grad_clip`` (optax.clip_by_global_norm in front of the optimizer) with
adam, adamw and sgd, at a clip that bites (a fifth of the first step's
gradient norm) and at one that does not (50 times it): three-step
trajectories against the JAX package's ``make_optimizer`` +
``make_train_step``, with the network, batches and tolerances of
``test_torch_port_optim.py``."""

import pytest
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from test_torch_port_optim import check_trajectory  # noqa: E402

# (optimizer, lr, momentum, weight_decay, clip as a multiple of the first step's gradient norm)
CLIPPED = {
    "adam_clip_bites": ("adam", 1e-3, 0.0, 0.0, 0.2),
    "adam_clip_idle": ("adam", 1e-3, 0.0, 0.0, 50.0),
    "adamw_clip_bites": ("adamw", 1e-3, 0.0, 0.5, 0.2),
    "adamw_clip_idle": ("adamw", 1e-3, 0.0, 0.5, 50.0),
    "sgd_clip_bites": ("sgd", 0.05, 0.9, 0.0, 0.2),
    "sgd_clip_idle": ("sgd", 0.05, 0.9, 0.0, 50.0),
}


@pytest.mark.parametrize("case", sorted(CLIPPED))
def test_clipped_three_step_trajectory_matches_jax(case):
    check_trajectory(*CLIPPED[case])
