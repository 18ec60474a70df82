"""The blocks the port's 3-D zoo adds, against the JAX package's on the CPU
in f32 (outputs and, through ``jax.vjp`` and autograd, input and parameter
gradients, the weights carried by ``convert.py``'s leaf map):
``InstanceNorm``, ``PReLU``, ``ops.fft.band_split``, ``DilationBlock``
(train mode, each padding mode), and the general ``TorchConv`` at V-Net's
(k5 p2; k2 s2), CSR-Net's (k3 s4 p0) and HighResNet's (k3 dilation 2)
settings (``test_torch_port_zoo3d_blocks.py``: the rest of the blocks); ``Dropout`` by its statistics; the
registry's last two networks, which it once refused, built at the JAX parameter counts.

The ``cuda``-marked case holds the conv kernels at the ragged stems of
Double U-Net (Cin 3) and FusionNet (Cin 4) against their plain versions on
a card and skips without one; there:
``python -m pytest --noconftest tests/test_torch_port_zoo3d_layers.py -m cuda``
(the JAX cases skip where flax is missing)."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu_torch.models import build_model
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn import blocks, norm, residual
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu as conv_op
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_wgrad as wgrad_op
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.fft import band_split
from torch_port_zoo3d import against_jax, jx, rand  # noqa: F401 (jx: a fixture)

@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax(jx, affine):
    """Per-sample, per-channel statistics over the spatial axes with the
    mean squared deviation (JAX's ``jnp.var``), eps 1e-5, at a mean far
    from zero."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn.norm import InstanceNorm as J

    x = rand((2, 5, 4, 6, 3), 1, loc=3.0, scale=0.5)
    dy, dx, dw = against_jax(jx, J(affine=affine), norm.InstanceNorm(3, affine=affine), x)
    assert dy <= 1e-5 and dx <= 1e-5 and dw <= 1e-5


@pytest.mark.parametrize("n", [1, 4])
def test_prelu_matches_jax(jx, n):
    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import PReLU as J

    x = rand((2, 3, 4, 5, 4), 2)
    dy, dx, dw = against_jax(jx, J(num_parameters=n), blocks.PReLU(n), x)
    assert dy == 0 and dx <= 1e-6 and dw <= 1e-6


def test_band_split_matches_jax(jx):
    """One rfft over D, H, W, the bands masked over H and W at 0.04 (so at
    H = W = 64 the low band keeps |f| < 0.04, two bins each side), in f32,
    batch elements kept apart; and bf16 in, bf16 out."""
    from general_medical_image_segmentation_cnn_framework_tpu.ops.fft import band_split as jax_band_split

    jax, jnp = jx
    x = rand((2, 4, 64, 50, 2), 4)
    want = [np.asarray(t) for t in jax_band_split(jnp.asarray(x), 0.04)]
    got = [t.numpy() for t in band_split(torch.from_numpy(x), 0.04)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    alone = band_split(torch.from_numpy(x[1:]), 0.04)[0].numpy()
    np.testing.assert_allclose(alone, got[0][1:], rtol=1e-5, atol=1e-6)
    low, high = band_split(torch.from_numpy(x).bfloat16(), 0.04)
    assert low.dtype == high.dtype == torch.bfloat16 and low.shape == x.shape


@pytest.mark.parametrize("padding_mode", ["constant", "reflect", "replicate"])
def test_dilation_block_matches_jax(jx, padding_mode):
    """HighResNet's DilationBlock in train mode: a residual block of 2
    pre-activation conv blocks at dilation 2, 4 -> 8 channels with the
    'pad' shortcut, BatchNorm on batch statistics."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn.residual import DilationBlock as J

    x = rand((2, 6, 7, 8, 4), 6)
    jax_block = J(out_channels=8, dilation=2, num_residual_blocks=1, padding_mode=padding_mode)
    port = residual.DilationBlock(4, 8, 2, num_residual_blocks=1, padding_mode=padding_mode).train()
    dy, dx, dw = against_jax(jx, jax_block, port, x, mutable=True, train=True)
    assert dy <= 2e-5 and dx <= 1e-4 and dw <= 1e-4


# (kernel_size, stride, padding, dilation, use_bias): V-Net's k5 and k2 s2, CSR-Net's k3 s4, HighResNet's dilated k3
CONVS = {"vnet_k5": (5, 1, 2, 1, True), "vnet_k2s2": (2, 2, 0, 1, True), "csrnet_k3s4": (3, 4, 0, 1, True),
         "highresnet_k3d2": (3, 1, 0, 2, False)}


@pytest.mark.parametrize("name", CONVS)
def test_general_torch_conv_matches_jax(jx, name):
    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import TorchConv as J

    k, s, p, d, bias = CONVS[name]
    x = rand((2, 12, 12, 12, 4), 7)
    jax_conv = J(features=6, kernel_size=k, stride=s, padding=p, dilation=d, use_bias=bias)
    port = blocks.TorchConv(4, 6, kernel_size=k, stride=s, padding=p, dilation=d, use_bias=bias)
    assert not port.hand_kernel and (port.bias is None) == (not bias)
    dy, dx, dw = against_jax(jx, jax_conv, port, x)
    assert dy <= 1e-5 and dx <= 1e-5 and dw <= 1e-5


def test_dropout_rate_broadcast_and_scale():
    """Kept with probability 1 - p and scaled by 1/(1 - p); whole channels
    with ``broadcast_dims`` (1, 2, 3); the identity in eval and at p = 0;
    the same draws for the same seed."""
    x = torch.ones(4, 8, 8, 8, 64)
    drop = blocks.Dropout(0.6, generator=torch.Generator().manual_seed(1)).train()
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.4) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.4))
    whole = blocks.Dropout(0.5, broadcast_dims=(1, 2, 3), generator=torch.Generator().manual_seed(2)).train()
    y = whole(x)
    per_channel = (y != 0).float().mean(dim=(1, 2, 3))
    assert set(per_channel.unique().tolist()) <= {0.0, 1.0}
    assert abs(per_channel.mean().item() - 0.5) < 0.1
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 2.0))
    assert torch.equal(whole.eval()(x), x) and torch.equal(blocks.Dropout(0.0).train()(x), x)
    again = blocks.Dropout(0.6, generator=torch.Generator().manual_seed(1)).train()
    assert torch.equal(again(x), drop.__class__(0.6, generator=torch.Generator().manual_seed(1)).train()(x))


def test_registry_refuses_the_six_not_ported_yet(jx):
    """None is left: the last two, unetr and vtnet, build from their shipped
    configs (configs/config/unetr.yaml, vtnet.yaml: 128^3 patches) with the
    parameter counts of the JAX registry's models (``jax.eval_shape``);
    an unknown name is still refused."""
    from general_medical_image_segmentation_cnn_framework_tpu.config import compose as jax_compose
    from general_medical_image_segmentation_cnn_framework_tpu.models.registry import build_model as jax_build_model
    from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose

    jax, jnp = jx
    for network, want in (("unetr", 146_593_346), ("vtnet", 20_738_556)):
        config = compose([f"config={network}"], make_run_dir=False)
        assert tuple(config.patch_size) == (128, 128, 128)
        model = build_model(config)
        assert sum(p.numel() for p in model.parameters()) == want, network
        flax_model = jax_build_model(jax_compose([f"config={network}"], make_run_dir=False))
        shapes = jax.eval_shape(lambda: flax_model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.zeros((1, 128, 128, 128, 1)),
            train=False))
        assert sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"])) == want
    with pytest.raises(KeyError, match="unknown network 'nope'"):
        build_model(ConfigDict(network="nope", in_classes=1, out_classes=2))


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [3, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_stem_kernels_match_plain_versions_on_cuda(cin, dtype, monkeypatch):
    """The stems of Double U-Net's fine U-Net (3 -> 64) and FusionNet's
    fusion head (4 -> 64), which take the kernels' non-wgmma variants, at
    2 x 32^3: the conv forward (relu off and on) and the input gradient
    within 1e-2 (bf16) or 1e-4 (f32) of max(1, max|plain|), the weight
    gradient within 1e-4 of max(1, max|dw|) against the f64 plain version."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # the plain version in true f32
    dev = torch.device("cuda")
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    gen = torch.Generator(device=dev).manual_seed(cin)
    x = torch.randn(2, 32, 32, 32, cin, device=dev, generator=gen).to(dtype)
    g = torch.randn(2, 32, 32, 32, 64, device=dev, generator=gen).to(dtype)
    w = (torch.randn(3, 3, 3, cin, 64, device=dev, generator=gen) * (27 * cin) ** -0.5).to(dtype)
    b = 0.1 * torch.randn(64, device=dev, generator=gen)
    for relu in (False, True):
        got = conv_op.conv3d_bn_relu(x, w, b, relu=relu).float()
        want = conv_op.conv3d_bn_relu_reference(x.float(), w.float(), b, relu=relu)
        assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    got = conv_op.conv3d_input_grad(g, w).float()
    want = conv_op.conv3d_input_grad_reference(g.float(), w.float()).float()
    assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    dw = wgrad_op.conv3d_wgrad(x, g).double()
    want = wgrad_op.conv3d_wgrad_reference(x.double(), g.double())
    assert (dw - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
