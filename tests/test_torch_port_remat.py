"""``remat`` / ``remat_policy`` of the port's UNet3D (the JAX
``nn.remat`` of its ConvBlocks): under every policy a train step's loss,
gradients and BatchNorm running statistics are those without remat, bit for
bit (f32 on the CPU, init_features=4, batch 4 x 16^3), with less kept for
the backward; the statistics move once per step, though the full policy
runs each block's forward twice."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package makes the random weights: without it the file skips

from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu_torch.models import build_model
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from test_torch_port_unet3d import jax_unet, port_unet


def _saved_bytes(model, x, gt, loss_fn):
    """(loss, bytes autograd keeps for the backward) of one forward."""
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = loss_fn(model(x), gt)
    return loss, total


@pytest.mark.parametrize("policy", ["", "full", "conv", "dots"])
def test_remat_keeps_gradients_and_running_statistics_bit_exact(policy):
    """A train step's loss, every gradient and every BatchNorm running
    statistic under ``remat=true, remat_policy=policy`` equal those without
    remat (torch.equal, f32 on the CPU), with less kept for the backward:
    the full policy keeps each block's input alone, conv and dots also its
    conv output. The running statistics move once per step."""
    _, variables = jax_unet(4, seed=42)
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.normal(size=(4, 16, 16, 16, 1)).astype(np.float32))
    gt = torch.from_numpy((rng.uniform(size=(4, 16, 16, 16, 1)) > 0.6).astype(np.float32))
    loss_fn = port_train.make_loss_and_metric(ConfigDict(out_classes=2, loss="bce"))
    results = []
    for remat in (False, True):
        model = UNet3D(1, 2, 4, remat=remat, remat_policy=policy)
        model.load_state_dict(port_unet(variables, 4).state_dict())
        model.train()
        loss, kept = _saved_bytes(model, x, gt, loss_fn)
        loss.backward()
        results.append((loss, kept, {n: p.grad for n, p in model.named_parameters()},
                        {n: b for n, b in model.named_buffers()}))
    (loss0, kept0, grads0, stats0), (loss1, kept1, grads1, stats1) = results
    assert torch.equal(loss0, loss1)
    for name, g in grads0.items():
        assert torch.equal(g, grads1[name]), name
    for name, b in stats0.items():
        assert torch.equal(b, stats1[name]), name
    assert not torch.equal(stats0["blocks.9.bn.running_var"], port_unet(variables, 4).blocks[9].bn.running_var)
    assert kept1 < (0.35 if policy in ("", "full") else 0.6) * kept0, (kept1, kept0)


def test_remat_policy_names_and_unet2d():
    with pytest.raises(ValueError, match="unknown remat_policy 'offload'"):
        UNet3D(1, 2, 2, remat=True, remat_policy="offload")
    assert UNet3D(1, 2, 2, remat=False, remat_policy="offload").blocks[0].remat is None  # read only under remat
    assert [UNet3D(1, 2, 2, remat=True, remat_policy=p).blocks[0].remat for p in ("", "full", "conv", "dots")] == [
        "full", "full", "conv", "dots"]
    # UNet2D has no remat in the JAX package either: the keys are accepted and change nothing
    cfg = ConfigDict(network="unet2d", in_classes=1, out_classes=2, precision="float32", init_type="kaiming",
                     seed=0, remat=True, remat_policy="conv")
    assert all(not hasattr(b, "remat") or b.remat is None for b in build_model(cfg).blocks)
