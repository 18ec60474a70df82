"""The port's UNet2D against the JAX package's, with the same weights
carried across by ``convert.unet2d_state_dict_from_flax``: logits in eval
and train mode, one train step's gradients and BatchNorm running
statistics, bf16 mask agreement, the bilinear up with its pad-to-match,
the registry and the head's init.

UNet2D has no width knob, so it runs at its full published width
(64/128/256/512/512) at a small spatial size: batch 4 at 32^2, where the
2^2 bottleneck normalises 16 values per channel (not a degenerate
BatchNorm). All on the CPU, where the port runs its kernels' plain
versions.
"""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu import train as jax_train
from general_medical_image_segmentation_cnn_framework_tpu.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu.models.two_d.unet2d import UNet2D as FlaxUNet2D
from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import (
    resize_linear_align_corners as jax_resize,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import unet2d_state_dict_from_flax
from general_medical_image_segmentation_cnn_framework_tpu_torch.models import build_model, is_2d, make_forward
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.two_d.unet2d import UNet2D
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import resize_linear_align_corners
from test_torch_port_unet3d import random_variables

CONFIG = ConfigDict(
    network="unet2d", in_classes=1, out_classes=2, loss="bce", optimizer="adam", init_lr=1e-3,
    precision="float32", grad_accum=1, pipeline_stages=0,
)
N_PARAMS = 13_394_242  # and 7,936 BatchNorm running statistics: 13,402,178 numbers in all


def jax_unet2d(dtype=jnp.float32, seed=0):
    model = FlaxUNet2D(in_channels=1, classes=2, dtype=dtype)
    return model, random_variables(model, jnp.zeros((1, 32, 32, 1)), seed)


def port_unet2d(variables, dtype=torch.float32):
    model = UNet2D(1, 2, dtype=dtype)
    model.load_state_dict(unet2d_state_dict_from_flax(variables["params"], variables["batch_stats"]))
    return model


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_flax_tree_converts_and_the_parameter_count_matches():
    model, variables = jax_unet2d()
    assert variables["params"]["ConvBlock_10"]["TorchConv_0"]["Conv_0"]["kernel"].shape == (3, 3, 1024, 256)
    assert variables["params"]["TorchConv_0"]["Conv_0"]["kernel"].shape == (1, 1, 64, 2)
    n_jax = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables["params"]))
    port = port_unet2d(variables)
    assert n_jax == sum(p.numel() for p in port.parameters()) == N_PARAMS
    assert port.state_dict().keys() == UNet2D().state_dict().keys()


@pytest.mark.parametrize("hw", [(32, 32), (34, 30)])
def test_eval_logits_match_jax(hw):
    """f32, batch 4, eval mode (BatchNorm folded into each conv in the port,
    applied after it in JAX): within 2e-4 of the logit scale. 34 x 30 makes
    the bilinear up of the 8-row map 16 rows tall against a 17-row skip, so
    the pad-to-match pads."""
    model, variables = jax_unet2d(seed=1)
    x = _x((4, *hw, 1), 2)
    want = np.asarray(jax.jit(lambda v, t: model.apply(v, t, train=False))(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = port_unet2d(variables).eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, *hw, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * max(1.0, np.abs(want).max()))


def test_train_step_gradients_logits_and_running_stats_match_jax():
    """One train step through the 2-D adapter of both entry points
    (``make_forward``: [B, 1, H, W, C] patches in, the depth axis dropped and
    restored): train-mode logits within 2e-4 of their scale, the loss within
    1e-5, the BatchNorm running statistics the forward leaves within 1e-5,
    the head's gradient within 1e-4 of its largest entry, and every other
    gradient within 1e-2 in relative L2 norm, except the conv biases before
    BatchNorm, whose true gradient is 0 (their f32 noise is held to 1e-6
    absolute).

    Why 1e-2 in norm below the head: the gradient is piecewise. At full
    width a few of the ~10^6 pre-ReLU values lie within f32 forward noise of
    0, so their ReLU mask differs between any two f32 runs, and train-mode
    BatchNorm spreads each flip over its channel. The port's own f32
    gradients differ from its f64 ones by up to 1.5e-2 of a tensor's
    largest entry (4e-3 in norm), and by 1.5e-5 when the f32 run takes the
    f64 run's ReLU masks (``test_torch_port_unet2d_f64.py``). A wrong tap,
    flip or transpose in a gradient kernel moves these by O(1)."""
    model, variables = jax_unet2d(seed=3)
    x = _x((4, 1, 32, 32, 1), 4)
    gt = (np.random.default_rng(5).uniform(size=(4, 1, 32, 32, 1)) > 0.7).astype(np.float32)
    forward = jax_train.make_forward(CONFIG, model)
    loss_and_metric = jax_train.make_loss_and_metric(CONFIG)

    def loss_fn(p):
        pred, updates = forward({"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                                True, {"dropout": jax.random.PRNGKey(0)}, ["batch_stats"])
        return loss_and_metric(pred, jnp.asarray(gt))[0], (pred, updates)

    (loss, (pred, updates)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    want = unet2d_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    port = port_unet2d(variables).train()
    got_pred = make_forward(CONFIG, port)(torch.from_numpy(x))
    got_loss, _ = port_train.make_loss_and_metric(CONFIG)(got_pred, torch.from_numpy(gt))
    got_loss.backward()
    pred = np.asarray(pred)
    assert got_pred.shape == pred.shape == (4, 1, 32, 32, 2)
    np.testing.assert_allclose(got_pred.detach().numpy(), pred, rtol=0, atol=2e-4 * max(1.0, np.abs(pred).max()))
    assert abs(got_loss.item() - float(loss)) <= 1e-5 * float(loss)
    for name, p in port.named_parameters():
        got, w = p.grad.double().numpy(), want[name].numpy().astype(np.float64)
        if name.endswith("conv.bias"):
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, err_msg=name)
        elif name.startswith("head"):
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
        else:
            assert np.linalg.norm(got - w) <= 1e-2 * np.linalg.norm(w), name
    for i in range(18):
        bn, stats = port.blocks[i].bn, updates["batch_stats"][f"ConvBlock_{i}"]["BatchNorm_0"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)


def test_bf16_masks_agree_with_jax():
    """bf16 rounds at other places in the two packages (the port rounds once
    after the folded conv and interpolates in f32, JAX rounds after the conv
    and after BN and lerps in bf16): compare by scale and mask agreement."""
    model, variables = jax_unet2d(jnp.bfloat16, seed=6)
    x = _x((4, 32, 32, 1), 7)
    want = np.asarray(jax.jit(lambda v, t: model.apply(v, t, train=False))(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = port_unet2d(variables, torch.bfloat16).eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.99


@pytest.mark.parametrize("shape", [(10, 14), (11, 13), (5, 1)])
def test_resize_linear_align_corners_matches_jax(shape):
    """f32, an odd 5 x 7 map to even and odd sizes, and an axis of length 1
    (JAX tiles it; torch's interpolate samples index 0 everywhere)."""
    x = _x((2, 5, 7, 3), 8)
    if shape == (5, 1):
        x = x[:, :, :1]
        shape = (9, 4)
    want = np.asarray(jax_resize(jnp.asarray(x), shape))
    got = resize_linear_align_corners(torch.from_numpy(np.ascontiguousarray(x)), shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_registry_builds_unet2d_from_its_config():
    config = compose(["config=unet2d"], make_run_dir=False)
    assert config.network == "unet2d" and tuple(config.patch_size) == (1, 128, 128)
    assert is_2d("unet2d") and is_2d("segnet") and not is_2d("unet")
    model = build_model(config)
    assert isinstance(model, UNet2D) and model.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS
    assert model.blocks[10].conv.weight.shape == (3, 3, 1024, 256)
    assert model.head.weight.shape == (1, 1, 64, 2) and model.head.weight.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(ConfigDict(network="segnet", in_classes=1, out_classes=2))


@pytest.mark.parametrize("init_type", ["normal", "kaiming"])
def test_head_draws_from_the_init_type(init_type):
    """The JAX head is a ``TorchConv`` (``kernel_initializer(init_type)``),
    not UNet3D's LeCun-normal ``nn.Conv``: std 0.02 for ``normal`` and
    sqrt(2 / 64) for ``kaiming`` (LeCun would give about 0.142), from the
    128 draws of the [1, 1, 64, 2] kernel; the bias is zero."""
    head = UNet2D(1, 2, init_type=init_type, seed=9).head
    want = {"normal": 0.02, "kaiming": (2 / 64) ** 0.5}[init_type]
    assert abs(head.weight.std().item() / want - 1) < 0.2
    assert torch.count_nonzero(head.bias) == 0
