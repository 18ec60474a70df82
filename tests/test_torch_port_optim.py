"""The port's optimizers, gradient clipping, gradient accumulation and EMA
against the JAX package's ``make_optimizer`` + ``make_train_step``: three
steps from one init on the same batches, f32 on the CPU, on a two-block
network (ConvBlock 1->4, ConvBlock 4->2: a k3 conv with bias, BatchNorm,
ReLU each, the UNet3D block) at batch 4 x 8^3, so that each optimizer
costs one small JAX compile.

Tolerances. After three steps every parameter and BatchNorm statistic is
held within 1e-5 of its tensor's largest entry, except the conv biases. A conv bias in front of BatchNorm has a true gradient of 0
(BatchNorm removes any shift): what each package computes is f32 rounding
noise, of different sign in each. SGD moves such a bias by lr times that
noise, which stays inside the limit; Adam and AdamW move it by about lr a
step whatever the noise's size, so for them a conv bias is held within
2 lr per step, and so is the running mean, which carries it."""

import functools

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)
from torch import nn

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu import train as jax_train
from general_medical_image_segmentation_cnn_framework_tpu.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import ConvBlock as FlaxConvBlock
from general_medical_image_segmentation_cnn_framework_tpu_torch import optim
from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import module_state_dict_from_flax
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import ConvBlock, ScopeNames
from test_torch_port_unet3d import random_variables

STEPS, BATCH, PATCH = 3, 4, 8


class FlaxTwoBlocks(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        x = FlaxConvBlock(features=4, kernel_size=3, padding=1, name="ConvBlock_0")(x, train)
        return FlaxConvBlock(features=2, kernel_size=3, padding=1, name="ConvBlock_1")(x, train)


class TwoBlocks(nn.Module):
    def __init__(self):
        super().__init__()
        names = ScopeNames()
        self.blocks = nn.ModuleList([names(ConvBlock(1, 4)), names(ConvBlock(4, 2))])

    def forward(self, x):
        return self.blocks[1](self.blocks[0](x))


@functools.lru_cache(maxsize=None)
def _variables(seed):
    return random_variables(FlaxTwoBlocks(), jnp.zeros((1, PATCH, PATCH, PATCH, 1)), seed)


def _init(seed=21):
    model, variables = FlaxTwoBlocks(), _variables(seed)
    port = TwoBlocks()
    port.load_state_dict(_state_dict(variables["params"], variables["batch_stats"]))
    return model, variables, port.train()


def _state_dict(params, batch_stats=None):
    as_numpy = functools.partial(jax.tree_util.tree_map, np.asarray)
    return module_state_dict_from_flax(TwoBlocks(), as_numpy(params), batch_stats and as_numpy(batch_stats))


def _batches(seed=22):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BATCH, PATCH, PATCH, PATCH, 1)).astype(np.float32),
             (rng.uniform(size=(BATCH, PATCH, PATCH, PATCH, 1)) > 0.6).astype(np.float32))
            for _ in range(STEPS)]


def _config(**kw):
    base = dict(network="unet", out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3, weight_decay=0.0,
                momentum=0.0, grad_clip=0.0, grad_accum=1, pipeline_stages=0)
    return ConfigDict({**base, **kw})


def _jax_run(cfg, model, variables, batches, ema_decay=None):
    tx = jax_train.make_optimizer(cfg)
    step = jax_train.make_train_step(cfg, model, tx)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    opt_state = tx.init(params)
    ema = jax.tree_util.tree_map(jnp.array, params)  # a copy: the step donates params
    # the JAX train loop's ema_update (train.py:727-731), a closure there
    ema_update = jax.jit(lambda e, p: jax.tree_util.tree_map(
        lambda a, b: ema_decay * a + (1.0 - ema_decay) * b.astype(a.dtype), e, p))
    scalars = []
    for x, gt in batches:
        params, stats, opt_state, loss, dice = step(params, stats, opt_state, jnp.asarray(x), jnp.asarray(gt),
                                                    jax.random.PRNGKey(0))
        if ema_decay:
            ema = ema_update(ema, params)
        scalars.append((float(loss), float(dice)))
    return _state_dict(params, stats), scalars, (_state_dict(ema) if ema_decay else None)


def _port_run(cfg, port, batches, ema_decay=None):
    optimizer = port_train.make_optimizer(cfg, port.parameters())
    step = port_train.make_train_step(port, optimizer, port_train.make_loss_and_metric(cfg), int(cfg.grad_accum))
    ema = optim.EMA(port, ema_decay) if ema_decay else None
    scalars = []
    for x, gt in batches:
        loss, dice = step(torch.from_numpy(x), torch.from_numpy(gt))
        if ema is not None:
            ema.update(port)
        scalars.append((float(loss), float(dice)))
    return port.state_dict(), scalars, optimizer, (ema.state_dict(port) if ema else None)


def _assert_close(got, want, lr, adam):
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        loose = adam and (name.endswith("conv.bias") or name.endswith("running_mean"))
        atol = 2 * lr * STEPS if loose else 1e-5 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def _assert_scalars(got, want):
    """Each step's loss within 1e-5 relative; its dice, a ratio of voxel
    counts of thresholded logits (about 1,500 voxels in 2 x 8^3 x 4), within
    2e-3: two voxels whose logits sit within f32 noise of the threshold."""
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=1e-5)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=0, atol=2e-3)


def _grad_norm(port, batch, cfg):
    loss, _ = port_train.make_loss_and_metric(cfg)(port(torch.from_numpy(batch[0])), torch.from_numpy(batch[1]))
    grads = torch.autograd.grad(loss, list(port.parameters()))
    return float(torch.sqrt(sum((g * g).sum() for g in grads)))


# (optimizer, lr, momentum, weight_decay, clip: None, or the clip as a multiple of the first step's gradient norm)
OPTIMIZERS = {
    "adamw": ("adamw", 1e-3, 0.0, 0.5, None),
    "sgd_momentum": ("sgd", 0.05, 0.9, 0.0, None),
    "sgd_plain": ("sgd", 0.05, 0.0, 0.0, None),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_three_step_trajectory_matches_jax(case):
    check_trajectory(*OPTIMIZERS[case])


def check_trajectory(name, lr, momentum, wd, clip):
    """Three steps of ``name`` in both packages from one init: parameters,
    BatchNorm statistics, losses and dice (and with AdamW its two groups;
    with a clip below the gradient norm, that the clip changed the run)."""
    model, variables, port = _init()
    batches = _batches()
    base = _config(optimizer=name, init_lr=lr, momentum=momentum, weight_decay=wd)
    grad_clip = 0.0 if clip is None else clip * _grad_norm(_init()[2], batches[0], base)
    cfg = _config(optimizer=name, init_lr=lr, momentum=momentum, weight_decay=wd, grad_clip=grad_clip)
    want, want_scalars, _ = _jax_run(cfg, model, variables, batches)
    got, got_scalars, optimizer, _ = _port_run(cfg, port, batches)
    _assert_close(got, want, lr, adam=name != "sgd")
    _assert_scalars(got_scalars, want_scalars)
    if name == "adamw":  # the decay reaches the kernels only, as the optax mask ndim(p) > 1
        decayed, plain = optimizer.param_groups
        assert decayed["weight_decay"] == wd and all(p.dim() > 1 for p in decayed["params"])
        assert plain["weight_decay"] == 0.0 and all(p.dim() == 1 for p in plain["params"])
        assert len(decayed["params"]) == 2 and len(plain["params"]) == 6
    if clip is not None and clip < 1:  # the clip bit: the run differs from the one without it
        _, unclipped, _, _ = _port_run(base, _init()[2], batches)
        assert unclipped != got_scalars


def test_adamw_leaves_one_dimensional_tensors_undecayed():
    """With zero gradients AdamW's update is the decay alone: the kernels
    shrink by 1 - lr * wd, every 1-D tensor stays as it was."""
    port = _init()[2]
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    optimizer = port_train.make_optimizer(_config(optimizer="adamw", init_lr=0.1, weight_decay=0.5), port.parameters())
    for p in port.parameters():
        p.grad = torch.zeros_like(p)
    optimizer.step()
    for n, p in port.named_parameters():
        want = before[n] * (1 - 0.1 * 0.5) if p.dim() > 1 else before[n]
        torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=0)


def test_clip_by_global_norm_is_optax_s():
    """``optim.clip_by_global_norm_`` against ``optax.clip_by_global_norm``
    on the same gradients: g / ||g|| * clip within 1e-6 relative where the
    clip bites, g itself (the same bits) where it does not."""
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 3, 3, 2, 4), (4,), (7, 5))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    for clip in (0.5 * norm, 2.0 * norm):
        want, _ = optax.clip_by_global_norm(clip).update([jnp.asarray(g) for g in grads], optax.EmptyState())
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        optim.clip_by_global_norm_(torch.optim.SGD(params, lr=0.1), clip)
        for p, w, g in zip(params, want, grads):
            if clip > norm:
                assert np.array_equal(p.grad.numpy(), g)
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_grad_accum_matches_jax_train_step_accum():
    """``grad_accum=2``: two microbatches of 2, their gradients averaged into
    one Adam step, BatchNorm's statistics moved once per microbatch, loss
    and dice the microbatch means: parameters, running statistics, loss and
    dice of three steps against the JAX ``train_step_accum``."""
    model, variables, port = _init()
    batches = _batches(seed=23)
    cfg = _config(grad_accum=2)
    want, want_scalars, _ = _jax_run(cfg, model, variables, batches)
    got, got_scalars, _, _ = _port_run(cfg, port, batches)
    _assert_close(got, want, 1e-3, adam=True)
    _assert_scalars(got_scalars, want_scalars)
    # not the full-batch step: the running statistics moved twice a step
    full, _, _, _ = _port_run(_config(), _init()[2], batches)
    assert not torch.allclose(full["blocks.0.bn.running_var"], got["blocks.0.bn.running_var"])
    step = port_train.make_train_step(port, torch.optim.SGD(port.parameters(), lr=0.1),
                                      port_train.make_loss_and_metric(cfg), 3)
    with pytest.raises(AssertionError, match="grad_accum=3 must divide batch_size"):
        step(*map(torch.from_numpy, batches[0]))


def test_ema_matches_the_jax_ema_update():
    """EMA of the parameters (decay 0.9) after three AdamW steps, against the
    JAX loop's ``ema_update`` of its own trajectory: within the limits of
    the parameters; the BatchNorm buffers of the EMA's state dict are the
    run's own."""
    model, variables, port = _init()
    batches = _batches(seed=24)
    cfg = _config(optimizer="adamw", weight_decay=0.5)
    _, _, want = _jax_run(cfg, model, variables, batches, ema_decay=0.9)
    got_sd, _, _, got = _port_run(cfg, port, batches, ema_decay=0.9)
    _assert_close({k: v for k, v in got.items() if k in want}, want, 1e-3, adam=True)
    for name, t in got.items():
        if "running" in name:
            assert torch.equal(t, got_sd[name])
        else:
            assert t.dtype == torch.float32 and not torch.equal(t, got_sd[name])
    with pytest.raises(AssertionError, match="must be in"):
        optim.EMA(port, 1.0)
