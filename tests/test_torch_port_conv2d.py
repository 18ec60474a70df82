"""The port's 2-D k3 s1 conv (the KD = 1 instance of the conv kernels)
against the JAX package's Pallas ``conv2d_plane_tlayout``, and its
wrappers' contract.

On the CPU, ``conv2d_bn_relu``, ``conv2d_k3s1`` and ``conv2d_wgrad`` run the
kernels' plain versions. They are held to ``pallas_tlayout.conv2d_tlayout_cinpad``
in interpret mode at the shapes of the JAX package's own test (the batch
fold at W = 64 and the Cin = 3 pad included), within that test's limits:
2e-4 for the conv, 3e-4 for dx and 3e-3 for dw of its custom VJP. The
eval ConvBlock folds BatchNorm into one ``conv2d_bn_relu`` and is held to
the JAX 2-D ``ConvBlock`` in eval mode.

The CUDA kernels run only on a card: the ``cuda``-marked cases skip without
one; on the card, ``python -m pytest --noconftest tests/test_torch_port_conv2d.py -m cuda``.
"""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.conv3d_bn_relu import (
    conv2d_bn_relu,
    conv2d_bn_relu_reference,
    conv2d_input_grad,
    conv2d_input_grad_reference,
    conv2d_k3s1,
    conv3d_bn_relu,
    conv3d_input_grad,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.conv3d_wgrad import (
    conv2d_wgrad,
    conv2d_wgrad_reference,
    conv3d_wgrad,
)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.fixture
def tlayout(monkeypatch):
    pytest.importorskip("jax")
    from general_medical_image_segmentation_cnn_framework_tpu.ops import pallas_tlayout as ptl

    monkeypatch.setattr(ptl, "_INTERPRET", True)
    return ptl


def _pallas_conv2d(ptl, x, k):
    """NHWC conv through the Pallas T-layout kernel [N, H, C, W]."""
    import jax.numpy as jnp

    y = ptl.conv2d_tlayout_cinpad(jnp.transpose(x, (0, 1, 3, 2)), k)
    return jnp.transpose(y, (0, 1, 3, 2))


@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [
        (1, 8, 128, 32, 16),
        (2, 6, 256, 64, 8),
        (4, 8, 64, 32, 16),  # the Pallas kernel folds 2 batch slices into its lanes
        (1, 8, 128, 3, 8),  # the Pallas wrapper pads Cin to 32
    ],
)
def test_plain_conv2d_matches_pallas_plane_tlayout(tlayout, n, h, w, cin, cout):
    import jax.numpy as jnp

    x, k = _rand((n, h, w, cin), 81), _rand((3, 3, cin, cout), 82, scale=0.2)
    want = np.asarray(_pallas_conv2d(tlayout, jnp.asarray(x), jnp.asarray(k)))
    got = conv2d_bn_relu(torch.from_numpy(x), torch.from_numpy(k), torch.zeros(cout), relu=False).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_conv2d_k3s1_vjp_matches_jax_grad_through_pallas(tlayout):
    """dx and dw of the port's train conv (its input gradient and weight
    gradient, plain versions on the CPU) against ``jax.grad`` through the
    Pallas kernel's custom VJP (its dgrad on the same kernel, its wgrad in
    XLA); the bias gradient is the cotangent's sum over N, H, W."""
    import jax
    import jax.numpy as jnp

    n, h, w, cin, cout = 2, 6, 128, 32, 8
    x, k, ct = _rand((n, h, w, cin), 83), _rand((3, 3, cin, cout), 84, scale=0.2), _rand((n, h, w, cout), 85)

    def loss(x, k):
        return jnp.sum(_pallas_conv2d(tlayout, x, k) * ct)

    gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt, kt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(k).requires_grad_()
    bt = torch.zeros(cout, requires_grad=True)
    conv2d_k3s1(xt, kt, bt).backward(torch.from_numpy(ct))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=3e-4)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk), atol=3e-3)
    db = ct.astype(np.float64).sum(axis=(0, 1, 2))  # f32 summation order: 1e-5 of the largest
    np.testing.assert_allclose(bt.grad.numpy(), db, rtol=0, atol=1e-5 * np.abs(db).max())


def test_eval_convblock2d_matches_jax():
    """The port's eval 2-D ConvBlock (BatchNorm folded into one
    ``conv2d_bn_relu``) against the JAX ``ConvBlock`` in eval mode, with the
    same random weights and non-trivial BatchNorm statistics."""
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import ConvBlock as FlaxConvBlock
    from general_medical_image_segmentation_cnn_framework_tpu_torch.convert import module_state_dict_from_flax
    from general_medical_image_segmentation_cnn_framework_tpu_torch.nn.blocks import ConvBlock
    from test_torch_port_unet3d import random_variables

    x = _rand((2, 9, 7, 3), 1)
    block = FlaxConvBlock(features=8, kernel_size=3, padding=1)
    variables = random_variables(block, jnp.asarray(x), seed=2)
    assert variables["params"]["TorchConv_0"]["Conv_0"]["kernel"].shape == (3, 3, 3, 8)
    want = np.asarray(block.apply(variables, jnp.asarray(x), train=False))
    port = ConvBlock(3, 8, ndim=2)
    port.load_state_dict(module_state_dict_from_flax(port, variables["params"], variables["batch_stats"]))
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    x, k, b = (torch.from_numpy(a) for a in (_rand((2, 5, 7, 3), 3), _rand((3, 3, 3, 4), 4), _rand((4,), 5)))
    g = torch.from_numpy(_rand((2, 5, 7, 4), 6))
    counters = (conv2d_bn_relu, conv2d_input_grad, conv2d_wgrad, conv3d_bn_relu, conv3d_input_grad, conv3d_wgrad)
    before = [f.launches for f in counters]
    for relu in (True, False):
        torch.testing.assert_close(conv2d_bn_relu(x, k, b, relu), conv2d_bn_relu_reference(x, k, b, relu))
    torch.testing.assert_close(conv2d_input_grad(g, k), conv2d_input_grad_reference(g, k))
    torch.testing.assert_close(conv2d_wgrad(x, g), conv2d_wgrad_reference(x, g), rtol=0, atol=0)
    y = conv2d_bn_relu(x.bfloat16(), k.bfloat16(), b)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 5, 7, 4)
    assert conv2d_wgrad(x.bfloat16(), g.bfloat16()).dtype == torch.float32
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("bad", ["w_rank", "x_rank", "w_cin", "b_dtype", "noncontig"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, w, b, g = torch.zeros(1, 3, 4, 2), torch.zeros(3, 3, 2, 5), torch.zeros(5), torch.zeros(1, 3, 4, 5)
    if bad == "w_rank":
        w = torch.zeros(3, 3, 3, 2, 5)  # a 3-D kernel on a 2-D input
    elif bad == "x_rank":
        x, g = torch.zeros(1, 1, 3, 4, 2), torch.zeros(1, 1, 3, 4, 5)
    elif bad == "w_cin":
        w = torch.zeros(3, 3, 3, 5)
    elif bad == "b_dtype":
        b = b.double()
    elif bad == "noncontig":
        x, g = torch.zeros(1, 4, 3, 2).transpose(1, 2), torch.zeros(1, 4, 3, 5).transpose(1, 2)
    calls = [lambda: conv2d_bn_relu(x, w, b)]
    if bad in ("x_rank", "noncontig"):
        calls.append(lambda: conv2d_wgrad(x, g))
    if bad in ("w_rank", "x_rank"):
        calls.append(lambda: conv2d_k3s1(x, w, b))
    for call in calls:
        with pytest.raises((TypeError, ValueError)):
            call()


def test_conv2d_wgrad_reference_is_the_conv2d_weight_gradient():
    x, g = torch.from_numpy(_rand((2, 5, 7, 3), 7)).double(), torch.from_numpy(_rand((2, 5, 7, 4), 8)).double()
    want = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (4, 3, 3, 3), g.permute(0, 3, 1, 2), padding=1)
    torch.testing.assert_close(conv2d_wgrad_reference(x, g), want.permute(2, 3, 1, 0), rtol=1e-12, atol=1e-12)


def opcheck_conv2d(device, dtype):
    """``torch.library.opcheck`` of the registered 2-D operator on
    ``device``, for relu on and off."""
    x = torch.from_numpy(_rand((2, 5, 7, 8), 41)).to(device, dtype)
    k = torch.from_numpy(_rand((3, 3, 8, 16), 42, scale=72**-0.5)).to(device, dtype)
    b = torch.from_numpy(_rand((16,), 43)).to(device)
    for relu in (True, False):
        torch.library.opcheck(torch.ops.gmist_torch.conv2d_bn_relu.default, (x, k, b, relu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registered_operator_passes_opcheck_on_cpu(dtype):
    opcheck_conv2d(torch.device("cpu"), dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.cuda
def test_registered_operator_passes_opcheck_on_cuda(cuda_device, dtype):
    before = conv2d_bn_relu.launches
    opcheck_conv2d(cuda_device, dtype)
    assert conv2d_bn_relu.launches > before  # the operator's CUDA kernel is the hand kernel


# (N, H, W, Cin, Cout): UNet2D's stem, its first decoder conv (1024 -> 256) and
# that conv's input gradient shape (256 -> 1024, the largest Cout), a ragged
# grid with channels multiples of 8 (the wgmma path in bf16) and one with
# ragged channels (the scalar-gather path)
CUDA_SHAPES = [
    (2, 16, 16, 1, 64),
    (2, 8, 8, 1024, 256),
    (2, 8, 8, 256, 1024),
    (3, 17, 23, 64, 72),
    (1, 17, 23, 3, 5),
    # the wgmma variants: UNet2D's 8^2 bottleneck, where the forward splits K; ragged
    # Cout and Cin != Cout on 234 pixels (not a multiple of the 64-voxel or 128-voxel
    # tiles); a Cout of one 8-channel chunk
    (16, 8, 8, 512, 512),
    (2, 9, 13, 24, 40),
    (2, 11, 7, 136, 8),
]


@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.cuda
def test_cuda_conv2d_kernels_match_plain_versions(cuda_device, shape, dtype):
    """The 2-D forward, input gradient and weight gradient on the card
    against their plain versions on the CPU (f32, no TF32) from the same
    rounded inputs: forward and input gradient within 1e-4 in f32 and 1e-2
    in bf16 (one rounding of the output), the f32 weight gradient within
    1e-4 of an f64 oracle, each relative to max(1, max|plain|); each wrapper
    adds one to its own count only."""
    n, h, w, cin, cout = shape
    x = torch.from_numpy(_rand((n, h, w, cin), 31)).to(dtype)
    k = torch.from_numpy(_rand((3, 3, cin, cout), 32, scale=(9 * cin) ** -0.5)).to(dtype)
    b = torch.from_numpy(_rand((cout,), 33))
    g = torch.from_numpy(_rand((n, h, w, cout), 34)).to(dtype)
    xd, kd, bd, gd = (t.to(cuda_device) for t in (x, k, b, g))
    counters = (conv2d_bn_relu, conv2d_input_grad, conv2d_wgrad, conv3d_bn_relu, conv3d_input_grad, conv3d_wgrad)
    before = [f.launches for f in counters]
    y, dx, dw = conv2d_bn_relu(xd, kd, bd), conv2d_input_grad(gd, kd), conv2d_wgrad(xd, gd)
    torch.cuda.synchronize()
    assert [f.launches - b0 for f, b0 in zip(counters, before)] == [1, 1, 1, 0, 0, 0]
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want in ((y, conv2d_bn_relu_reference(x.float(), k.float(), b)),
                      (dx, conv2d_input_grad_reference(g.float(), k.float()))):
        assert got.dtype == dtype and got.shape == want.shape
        assert (got.float().cpu() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    want = conv2d_wgrad_reference(x.double(), g.double())
    assert dw.dtype == torch.float32 and dw.shape == want.shape
    assert (dw.double().cpu() - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
