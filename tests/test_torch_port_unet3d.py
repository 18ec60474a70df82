"""The port's eval ConvBlock and UNet3D against the JAX package's, with the
same weights carried across by ``convert.py``, plus the checkpoint reader
and the registry."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu.checkpoint import save_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu.models.three_d.unet3d import (
    UNet3D as FlaxUNet3D,
)
from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import (
    ConvBlock as FlaxConvBlock,
)
from general_medical_image_segmentation_cnn_framework_tpu.nn.norm import BatchNorm as FlaxBatchNorm
from general_medical_image_segmentation_cnn_framework_tpu.ops import pallas_conv
from general_medical_image_segmentation_cnn_framework_tpu_torch.checkpoint import load_checkpoint
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import (
    convert_checkpoint,
    module_state_dict_from_flax,
    read_flax_msgpack,
    state_dict_from_flax,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.models import build_model
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import ConvBlock
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.norm import BatchNorm


def random_variables(module, x, seed):
    """A Flax variable tree of ``module``'s shapes (traced, not compiled)
    filled from a numpy seed: fan-in scaled kernels, and non-trivial BN
    statistics, BN affine parameters and conv biases, so that folding
    BatchNorm is not the identity."""
    rng = np.random.default_rng(seed)
    draw = {
        "kernel": lambda s: rng.normal(0.0, np.prod(s[:-1]) ** -0.5, s),
        "mean": lambda s: rng.normal(0.0, 0.2, s),
        "var": lambda s: rng.uniform(0.5, 2.0, s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.1, s),
    }
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, train=False))

    def walk(tree):
        return {
            k: walk(v) if isinstance(v, dict) else draw[k](v.shape).astype(np.float32)
            for k, v in tree.items()
        }

    return walk(dict(shapes))


def jax_unet(f, dtype=jnp.float32, seed=0):
    model = FlaxUNet3D(in_channels=1, out_channels=2, init_features=f, dtype=dtype)
    return model, random_variables(model, jnp.zeros((1, 16, 16, 16, 1)), seed)


def jax_eval(model, variables, x):
    return np.asarray(jax.jit(lambda v, t: model.apply(v, t, train=False))(variables, x))


def port_unet(variables, f, dtype=torch.float32):
    model = UNet3D(1, 2, f, dtype=dtype)
    model.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"]))
    return model.eval()


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_eval_convblock_matches_jax(route, monkeypatch):
    monkeypatch.setattr(pallas_conv, "_INTERPRET", True)
    x = np.random.default_rng(1).normal(size=(2, 4, 6, 5, 3)).astype(np.float32)
    block = FlaxConvBlock(features=8, kernel_size=3, padding=1, pallas=route == "pallas")
    variables = random_variables(block, jnp.asarray(x), seed=2)
    want = jax_eval(block, variables, jnp.asarray(x))

    port = ConvBlock(3, 8)
    port.load_state_dict(module_state_dict_from_flax(port, variables["params"], variables["batch_stats"]))
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_batchnorm_train_mode_matches_jax():
    """Batch statistics, E[x^2]-E[x]^2 variance and the unbiased running
    update with momentum 0.1, as in the JAX package's nn/norm.py."""
    x = np.random.default_rng(3).normal(1.0, 2.0, size=(2, 3, 4, 5, 6)).astype(np.float32)
    bn = FlaxBatchNorm(use_running_average=False)
    variables = {
        "params": {"scale": np.linspace(0.5, 1.5, 6, dtype=np.float32),
                   "bias": np.linspace(-0.2, 0.3, 6, dtype=np.float32)},
        "batch_stats": {"mean": np.full(6, 0.1, np.float32), "var": np.full(6, 1.5, np.float32)},
    }
    want, updated = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    port = BatchNorm(6)
    port.load_state_dict({
        "weight": torch.from_numpy(variables["params"]["scale"]),
        "bias": torch.from_numpy(variables["params"]["bias"]),
        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(variables["batch_stats"]["var"]),
    })
    got = port.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    stats = updated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)


def test_unet3d_logits_match_jax():
    """f=4 at 16^3, f32: the bar of test_unet3d_forward_matches_torch."""
    model, variables = jax_unet(4)
    x = np.random.default_rng(5).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    want = jax_eval(model, variables, jnp.asarray(x))
    with torch.inference_mode():
        got = port_unet(variables, 4)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 16, 16, 16, 2)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_unet3d_bf16_follows_jax_dtype_flow():
    """bf16 rounds at other places in the two packages (the port rounds
    once after the folded conv, JAX after the conv and again after BN), so
    compare by scale and by mask agreement, not bytes."""
    model, variables = jax_unet(4, dtype=jnp.bfloat16, seed=2)
    x = np.random.default_rng(6).normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    want = jax_eval(model, variables, jnp.asarray(x))
    with torch.inference_mode():
        got = port_unet(variables, 4, torch.bfloat16)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.05 * scale
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.99


def test_jax_checkpoint_converts_to_port_checkpoint(tmp_path):
    from flax import serialization

    _, variables = jax_unet(2, seed=3)
    src, dst = tmp_path / "latest_checkpoint.ckpt", tmp_path / "unet3d.pt"
    save_checkpoint(src, variables["params"], variables["batch_stats"], {}, epoch=7)

    with open(src, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = read_flax_msgpack(src)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    convert_checkpoint(src, dst)
    state = load_checkpoint(dst)
    assert state["epoch"] == 7
    expected = state_dict_from_flax(variables["params"], variables["batch_stats"])
    assert state["params"].keys() == expected.keys() == UNet3D(1, 2, 2).state_dict().keys()
    for k, v in expected.items():
        torch.testing.assert_close(state["params"][k], v, rtol=0, atol=0)


def test_registry_builds_unet3d_with_32_features_and_refuses_the_rest():
    model = build_model(ConfigDict(network="unet", in_classes=1, out_classes=2, precision="bfloat16"))
    assert isinstance(model, UNet3D) and model.dtype == torch.bfloat16
    assert model.blocks[0].conv.weight.shape == (3, 3, 3, 1, 32)
    assert model.blocks[0].conv.weight.dtype == torch.float32
    # every network of the JAX package is ported: UNETR builds at its from_config width (64^3 patches: the
    # JAX parameter count, from jax.eval_shape), and only an unknown name is refused
    unetr = build_model(ConfigDict(network="unetr", in_classes=1, out_classes=2, patch_size=(64, 64, 64)))
    assert sum(p.numel() for p in unetr.parameters()) == 146_249_282
    with pytest.raises(KeyError, match="unknown network 'nope'"):
        build_model(ConfigDict(network="nope", in_classes=1, out_classes=2))
