"""DenseVoxelNet and SkipDenseNet3D (fixed widths, 16^3, f32 on the CPU) of
the port against the JAX package's: eval logits after ``convert.py``,
converted JAX checkpoints with an Adam state (SkipDenseNet3D's grouped
heads: each JAX group's kernel and moments one slice of one port tensor),
``build_model`` with the JAX parameter counts; and DenseVoxelNet's eval
forward, which runs only what its returned y2 needs."""

import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips

from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.densevoxelnet3d import DenseVoxelNet  # noqa: E402,E501
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import TorchConv  # noqa: E402
from torch_port_zoo3d import check_checkpoint_converts, check_eval_logits, check_registry  # noqa: E402

CASES = ("densevoxelnet", "densenet")


@pytest.mark.parametrize("case", CASES)
def test_eval_logits_match_jax(case):
    check_eval_logits(case)


@pytest.mark.parametrize("case", CASES)
def test_jax_checkpoint_with_adam_converts(case, tmp_path):
    check_checkpoint_converts(case, tmp_path, with_adam=True)


@pytest.mark.parametrize("network", CASES)
def test_registry_builds_at_the_jax_width(network):
    check_registry(network)


def test_densevoxelnet_eval_runs_only_what_y2_needs():
    """The k3 s1 p1 convs a forward calls (``TorchConv.hand_kernel``, the
    hand-written kernel on a card): 24 in train mode, 12 in eval (the first
    dense block); ``return_both`` runs all 24 and gives (y2, y1), its y2
    the eval forward's."""
    model = DenseVoxelNet(1, 2, seed=3)
    calls = []
    for m in model.modules():
        if isinstance(m, TorchConv) and m.hand_kernel:
            m.register_forward_pre_hook(lambda module, args: calls.append(module))
    x = torch.randn(2, 16, 16, 16, 1, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.train()(x)
        assert len(calls) == 24
        calls.clear()
        y2 = model.eval()(x)
        assert len(calls) == 12 and y2.shape == (2, 16, 16, 16, 2)
        calls.clear()
        model.return_both = True
        both = model(x)
    assert len(calls) == 24 and both[1].shape == y2.shape and torch.equal(both[0], y2)
