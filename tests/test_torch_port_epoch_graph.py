"""``epoch_scan``'s CUDA graph on the card against the eager step it
captures (``ops/epoch_scan.py``): the same weights and plan give the same
per-step losses and weights; the learning rate written between epochs
reaches the replays (Adam's on the device; SGD's by a new capture); every
replay draws a new dropout mask; a checkpoint of the graph's capturable
Adam resumes a per-step run. Needs a CUDA card: the steps launch the
hand-written kernels, and a graph has no CPU mode (the CPU runs the eager
step, held against the JAX package in ``test_torch_port_epoch_scan.py``).
On the card: ``python -m pytest --noconftest tests/test_torch_port_epoch_graph.py -m cuda``."""

import copy

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
from general_medical_image_segmentation_cnn_framework_tpu_torch.checkpoint import restore_training_state, save_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.residual_unet3d import ResidualUNet3D
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import Dropout
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.epoch_scan import (
    build_epoch_plan,
    make_epoch_scan,
    stack_store,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.optim import set_lr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph and the hand-written kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _store(device, shape=(32, 32, 32), seed=0):
    rng = np.random.default_rng(seed)
    vols = [torch.from_numpy(rng.normal(size=shape + (1,)).astype(np.float32)).to(device) for _ in range(2)]
    labels = [torch.from_numpy((rng.uniform(size=shape + (1,)) > 0.6).astype(np.float32)).to(device) for _ in range(2)]
    return stack_store(vols), stack_store(labels)


def _scan(cfg, model, store):
    optimizer = port_train.make_optimizer(cfg, model.parameters())
    step = port_train.make_train_step(model, optimizer, port_train.make_loss_and_metric(cfg))
    return make_epoch_scan(cfg, model, optimizer, step, *store), optimizer


def _plan(seed, steps=3, batch=4):
    return build_epoch_plan(2, steps * batch // 2, batch, (32, 32, 32), (16, 16, 16), np.random.default_rng(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_graph_replays_the_eager_step(cuda_device, optimizer):
    """UNet3D f=8 in f32 from the same weights, 2 epochs of 3 steps of 4 x
    16^3: the graph's per-step losses within 1e-3 (relative) of the eager
    loop's, the weights after each epoch within 1e-3 in relative L2 (Adam's
    capturable arithmetic on the device rounds otherwise than its host
    form); with lr 0 in epoch 2 every parameter stays as epoch 1 left it,
    bit for bit (the schedule reaches the replays)."""
    cfg = ConfigDict(out_classes=2, loss="bce", optimizer=optimizer, momentum=0.9, init_lr=1e-3,
                     patch_size=(16, 16, 16), aug=False, seed=0)
    model = UNet3D(1, 2, 8, seed=1).to(cuda_device).train()
    eager_model = copy.deepcopy(model)
    store = _store(cuda_device)
    graph, _ = _scan(cfg, model, store)
    eager, _ = _scan(cfg, eager_model, store)
    for epoch, lr in enumerate((1e-3, 0.0)):
        set_lr(graph.optimizer, lr)
        set_lr(eager.optimizer, lr)
        before = [p.detach().clone() for p in model.parameters()]
        plan = _plan(epoch)
        got = graph(*plan)[0].cpu()
        eager.start_epoch(*plan)
        for _ in range(len(plan[0])):
            eager.step()
        want = eager.losses.cpu()
        assert graph.graph is not None and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-3, atol=0)
        for p, q in zip(model.parameters(), eager_model.parameters()):
            assert float((p - q).detach().norm()) <= 1e-3 * float(q.detach().norm()) + 1e-12
        if lr == 0.0:
            assert all(torch.equal(p, b) for p, b in zip(model.parameters(), before))
    # step 0 of each epoch whose graph was (re)captured ran eagerly: Adam's one capture, SGD's two
    captures = 1 if optimizer == "adam" else 2
    assert (graph.eager_steps, graph.replays) == (captures, 6 - captures)


@pytest.mark.cuda
def test_the_wrappers_count_launches_not_recordings(cuda_device):
    """The launch counts tick for the eager warm-up step and not for the
    capture: one step's worth after the first epoch, however many replays
    follow; the scan counts its replays."""
    from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu, conv3d_wgrad, fused_bce_dice

    counted = (conv3d_bn_relu.conv3d_bn_relu, conv3d_bn_relu.conv3d_input_grad, conv3d_wgrad.conv3d_wgrad,
               fused_bce_dice.bce_dice_sums, fused_bce_dice.bce_dice_grads)
    cfg = ConfigDict(out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3, patch_size=(16, 16, 16), aug=False,
                     seed=0)
    model = UNet3D(1, 2, 8, seed=1).to(cuda_device).train()
    scan, _ = _scan(cfg, model, _store(cuda_device))
    for f in counted:
        f.launches = 0
    scan(*_plan(0))
    one_step = [f.launches for f in counted]
    scan(*_plan(1))
    assert [f.launches for f in counted] == one_step and all(one_step)
    assert (scan.eager_steps, scan.replays) == (1, 5)


@pytest.mark.cuda
def test_each_replay_draws_a_new_dropout_mask(cuda_device):
    """res_unet's Dropout (p 0.6, called at five levels) under the graph: a
    forward hook captured with the step writes each replay's dropped
    positions; they differ from replay to replay at every level, and the
    losses stay finite."""
    cfg = ConfigDict(out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3, patch_size=(16, 16, 16), aug=False,
                     seed=0)
    model = ResidualUNet3D(1, 2, 4).to(cuda_device).train()
    (dropout,) = [m for m in model.modules() if isinstance(m, Dropout)]  # called at five levels
    masks = {}

    def record(module, args, out):
        buf = masks.setdefault(tuple(out.shape), torch.zeros(out.shape, dtype=torch.bool, device=out.device))
        buf.copy_((out == 0) & (args[0] != 0))

    dropout.register_forward_hook(record)
    scan, _ = _scan(cfg, model, _store(cuda_device))
    plan = _plan(0, steps=4)
    scan.start_epoch(*plan)
    scan.capture()  # runs step 0
    seen = []
    for _ in range(len(plan[0]) - 1):
        scan.graph.replay()
        seen.append([m.clone() for m in masks.values()])
    assert torch.isfinite(scan.losses).all() and len(masks) == 5
    # the 1^3 level's InstanceNorm leaves its input 0 at 16^3 patches: nothing to drop there
    levels = [i for i, m in enumerate(seen[0]) if m.any()]
    assert len(levels) == 4
    assert all(not torch.equal(a[i], b[i]) for a, b in zip(seen, seen[1:]) for i in levels)
    assert all(0.5 < float(replay[i].float().mean()) < 0.7 for replay in seen for i in levels)


@pytest.mark.cuda
def test_a_graph_checkpoint_resumes_a_per_step_run(cuda_device, tmp_path):
    cfg = ConfigDict(out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3, patch_size=(16, 16, 16), aug=False,
                     seed=0)
    model = UNet3D(1, 2, 4, seed=2).to(cuda_device).train()
    scan, optimizer = _scan(cfg, model, _store(cuda_device))
    scan(*_plan(0))
    assert optimizer.param_groups[0]["capturable"] and isinstance(optimizer.param_groups[0]["lr"], torch.Tensor)
    save_checkpoint(tmp_path / "scan.ckpt", model.state_dict(), 1, optimizer.state_dict(), "adam")
    resumed = UNet3D(1, 2, 4).to(cuda_device).train()
    per_step = port_train.make_optimizer(cfg, resumed.parameters())
    assert restore_training_state(tmp_path / "scan.ckpt", resumed, per_step, "adam") == 1
    state = per_step.state_dict()["state"][0]
    assert state["step"].device.type == "cpu" and int(state["step"]) == 3 and per_step.param_groups[0]["lr"] == 1e-3
    step = port_train.make_train_step(resumed, per_step, port_train.make_loss_and_metric(cfg))
    x = torch.randn(2, 16, 16, 16, 1, device=cuda_device)
    loss, _ = step(x, (x > 0).float())
    assert torch.isfinite(loss)
