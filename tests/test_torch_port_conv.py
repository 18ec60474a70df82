"""The port's fused Conv3d+BN+ReLU op against the JAX package's Pallas
kernels (interpret mode on the CPU), and its wrapper's contract.

The CUDA kernel itself runs only on a card: ``test_cuda_kernel_matches_reference``
is marked ``cuda`` and skips without one. On the card, run it without the JAX
conftest: ``python -m pytest --noconftest tests/test_torch_port_conv.py -m cuda``.
"""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.conv3d_bn_relu import (
    conv3d_bn_relu,
    conv3d_bn_relu_reference,
    fold_batchnorm,
)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _case(n, d, h, w, cin, cout, seed=0):
    x = _rand((n, d, h, w, cin), seed)
    k = _rand((3, 3, 3, cin, cout), seed + 1, scale=(27 * cin) ** -0.5)
    b = _rand((cout,), seed + 2)
    return x, k, b


def _port(x, k, b):
    return conv3d_bn_relu(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("cin", [1, 32])
def test_reference_matches_pallas_conv(cin, monkeypatch):
    jnp = pytest.importorskip("jax.numpy")
    from general_medical_image_segmentation_cnn_framework_tpu.ops import pallas_conv

    monkeypatch.setattr(pallas_conv, "_INTERPRET", True)
    x, k, b = _case(2, 4, 6, 5, cin, 8, seed=cin)
    want = np.asarray(
        pallas_conv.fused_conv3d_bn_relu(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    )
    np.testing.assert_allclose(_port(x, k, b), want, atol=1e-4)


@pytest.mark.parametrize("cin", [1, 32])
def test_reference_matches_tlayout_fused(cin, monkeypatch):
    jnp = pytest.importorskip("jax.numpy")
    from general_medical_image_segmentation_cnn_framework_tpu.ops import pallas_tlayout as ptl

    monkeypatch.setattr(ptl, "_INTERPRET", True)
    # T-layout needs W in {32, 64} with D divisible by 128 / W
    x, k, b = _case(1, 4, 8, 32, cin, 8, seed=10 + cin)
    got_t = ptl.conv3d_tlayout_fused_cinpad(
        ptl.to_tlayout(jnp.asarray(x)), jnp.asarray(k), bias=jnp.asarray(b), relu=True
    )
    want = np.asarray(ptl.from_tlayout(got_t))
    np.testing.assert_allclose(_port(x, k, b), want, atol=1e-4)


def test_fold_batchnorm_matches_jax():
    pytest.importorskip("jax")
    from general_medical_image_segmentation_cnn_framework_tpu.ops import pallas_conv

    rng = np.random.default_rng(3)
    k = rng.normal(size=(3, 3, 3, 4, 6)).astype(np.float32)
    args = [
        rng.normal(size=6), rng.uniform(0.5, 1.5, 6), rng.normal(size=6),
        rng.normal(size=6), rng.uniform(0.5, 2.0, 6),
    ]
    args = [a.astype(np.float32) for a in args]
    want_k, want_b = pallas_conv.fold_batchnorm(k, *args)
    got_k, got_b = fold_batchnorm(torch.from_numpy(k), *map(torch.from_numpy, args))
    assert got_k.dtype == got_b.dtype == torch.float32
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    x, k, b = _case(1, 3, 4, 5, 2, 3)
    before = conv3d_bn_relu.launches
    xt, kt, bt = map(torch.from_numpy, (x, k, b))
    for relu in (True, False):
        torch.testing.assert_close(
            conv3d_bn_relu(xt, kt, bt, relu), conv3d_bn_relu_reference(xt, kt, bt, relu)
        )
    y = conv3d_bn_relu(xt.bfloat16(), kt.bfloat16(), bt)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 3, 4, 5, 3)
    assert conv3d_bn_relu.launches == before


@pytest.mark.parametrize(
    "bad",
    ["x_dtype", "w_dtype", "b_dtype", "w_shape", "b_shape", "x_rank", "noncontig", "empty"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 2, 3, 4, 2)
    w = torch.zeros(3, 3, 3, 2, 5)
    b = torch.zeros(5)
    if bad == "x_dtype":
        x = x.half()
    elif bad == "w_dtype":
        w = w.bfloat16()
    elif bad == "b_dtype":
        b = b.double()
    elif bad == "w_shape":
        w = torch.zeros(3, 3, 3, 3, 5)
    elif bad == "b_shape":
        b = torch.zeros(4)
    elif bad == "x_rank":
        x = x[0]
    elif bad == "noncontig":
        x = torch.zeros(1, 2, 3, 2, 4).transpose(3, 4)
    elif bad == "empty":
        x = torch.zeros(0, 2, 3, 4, 2)
    with pytest.raises((TypeError, ValueError)):
        conv3d_bn_relu(x, w, b)


def opcheck_conv3d(device, dtype):
    """``torch.library.opcheck`` of the registered operator on ``device``:
    its schema, its fake kernel against the real one, and its dispatch
    under AOT autograd, for relu on and off."""
    x, k, b = (torch.from_numpy(a).to(device) for a in _case(2, 3, 4, 5, 8, 16))
    for relu in (True, False):
        torch.library.opcheck(torch.ops.gmist_torch.conv3d_bn_relu.default, (x.to(dtype), k.to(dtype), b, relu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registered_operator_passes_opcheck_on_cpu(dtype):
    """The registered operator's CPU kernel is the plain version, as the
    wrapper's CPU path."""
    opcheck_conv3d(torch.device("cpu"), dtype)
    x, k, b = map(torch.from_numpy, _case(1, 3, 4, 5, 2, 3))
    torch.testing.assert_close(torch.ops.gmist_torch.conv3d_bn_relu(x, k, b, True), conv3d_bn_relu(x, k, b))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.cuda
def test_registered_operator_passes_opcheck_on_cuda(cuda_device, dtype):
    before = conv3d_bn_relu.launches
    opcheck_conv3d(cuda_device, dtype)
    assert conv3d_bn_relu.launches > before  # the operator's CUDA kernel is the hand kernel


@pytest.mark.parametrize(
    "shape",
    [
        (1, 3, 5, 7, 1, 5),  # Cin=1 stem, K=27 < one K tile
        (2, 4, 6, 5, 3, 70),  # ragged K, Cout over one N tile
        (2, 5, 9, 11, 64, 130),  # ragged M and Cout
        (1, 2, 2, 2, 1, 1),
        # Cin, Cout multiples of 8: the wgmma variants in bf16
        (1, 3, 5, 7, 8, 24),  # ragged K (216 = 6.75 K tiles), Cout <= 32
        (2, 4, 6, 5, 32, 32),
        (2, 5, 9, 11, 64, 136),  # ragged M and Cout
        (3, 7, 3, 5, 16, 8),
        # the wgmma variant: K split at the 4^3 bottleneck, each tile width, ragged
        # Cout, Cin != Cout, 990 voxels (not a multiple of the 128-voxel tile)
        (16, 4, 4, 4, 512, 512),
        (2, 5, 9, 11, 24, 40),
        (1, 6, 7, 9, 40, 24),
        (2, 6, 6, 6, 64, 256),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.cuda
def test_cuda_kernel_matches_reference(cuda_device, shape, dtype):
    torch.backends.cudnn.allow_tf32 = False
    n, d, h, w, cin, cout = shape
    x, k, b = (torch.from_numpy(a).to(cuda_device) for a in _case(n, d, h, w, cin, cout))
    x, k = x.to(dtype), k.to(dtype)
    before = conv3d_bn_relu.launches
    for relu in (True, False):
        got = conv3d_bn_relu(x, k, b, relu)
        torch.cuda.synchronize()
        want = conv3d_bn_relu_reference(x.float(), k.float(), b, relu)
        # f32: summation order only; bf16: one rounding of the output
        tol = (1e-4 if dtype == torch.float32 else 1e-2) * max(1.0, want.abs().max().item())
        assert got.dtype == dtype
        assert (got.float() - want).abs().max().item() <= tol
    assert conv3d_bn_relu.launches == before + 2
