"""The blocks that FCN32s, DeepLabV3, PSPNet and MiniSeg add to the port,
and the repaired tie rule of ``max_pool``, against the JAX package's on
the CPU (outputs and, through ``jax.vjp`` and autograd, input and
parameter gradients, with ``torch_port_zoo3d.py``'s helpers).

``max_pool``: on small integers, where most windows tie, in f32 and bf16,
2-D and 3-D, at window 2 and at DeepLabV3's and PSPNet's k3 s2 p1, the
gradient of sum(w * max_pool(x)) goes wholly to each window's first
maximum in scan order, exactly as the JAX ``max_pool`` (XLA's window max)
gives it; the weights w are small integers too, so that the sums where
windows overlap are exact in bf16. And at UNet2D's first pool in bf16, on
ReLU'd activations rounded so that positive values tie, the input's
gradient equals the JAX one exactly (an ``amax`` over reshaped windows,
the port's pool before, splits each tie and fails this).

MiniSeg's grouped and depthwise convs (``TorchConv(groups=g)``: grouped
1x1 with 4 groups, depthwise k3 at dilation 2, depthwise k5 s2),
``avg_pool`` at k3 s1 and s2 with padding 1 (the padded cells counted as
zeros by both), PSPNet's adaptive average pool (segments that overlap,
and an output larger than the input), ``resize_linear`` where it
downsamples (PSPNet's 6 -> 4 at the tests' 32^2 slices) and upsamples
(3 -> 4), the per-channel ``PReLU``, and FCN32s's bilinear upscore init."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch.nn import blocks
from torch_port_zoo3d import against_jax, jx, rand  # noqa: F401 (jx: a fixture)

# name -> (x's shape NHWC / NDHWC, window, stride, padding)
POOLS = {"w2_2d": ((2, 8, 10, 3), 2, None, 0), "w2_3d": ((2, 6, 8, 4, 3), 2, None, 0),
         "k3s2p1_2d": ((2, 9, 8, 3), 3, 2, 1), "k3s2p1_3d": ((2, 5, 6, 7, 2), 3, 2, 1)}


def _first_max_gradient(x, w, window):
    """(the gradient of sum(w * max_pool(x)) for a window equal to its
    stride, by numpy: each window's cotangent on its first maximum in scan
    order, ``argmax``'s first occurrence; the number of tied windows)."""
    n, *spatial, c = x.shape
    grad, ties = np.zeros(x.shape, np.float32), 0
    for idx in np.ndindex(*w.shape):
        b, o, ch = idx[0], idx[1:-1], idx[-1]
        win = x[(b, *(slice(i * window, (i + 1) * window) for i in o), ch)]
        ties += int((win == win.max()).sum() > 1)
        first = np.unravel_index(np.argmax(win), win.shape)
        grad[(b, *(i * window + f for i, f in zip(o, first)), ch)] += w[idx]
    return grad, ties


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", POOLS)
def test_max_pool_gives_a_tie_to_the_first_maximum_as_jax(jx, name, dtype):
    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import max_pool as jax_max_pool

    jax, jnp = jx
    shape, window, stride, padding = POOLS[name]
    rng = np.random.default_rng(11)
    x = rng.integers(0, 3, size=shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(lambda t: jax_max_pool(t, window, stride, padding), jnp.asarray(x, jdt))
    w = rng.integers(1, 5, size=y.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(w, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    got = blocks.max_pool(xt, window, stride, padding)
    (got.float() * torch.from_numpy(w)).sum().backward()
    assert got.dtype == tdt and xt.grad.dtype == tdt
    np.testing.assert_array_equal(got.float().detach().numpy(), np.asarray(y, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want, np.float32))
    if stride is None:  # windows equal to their stride: each cotangent on its window's first maximum
        first, ties = _first_max_gradient(x, w, window)
        np.testing.assert_array_equal(xt.grad.float().numpy(), first)
        assert ties > w.size // 2


def test_unet2d_first_pool_bf16_gradient_equals_jax(jx):
    """UNet2D's first pool (2x2 over its 64-wide first level, at the tests'
    32^2 slices) in bf16 on ReLU'd activations rounded to quarters, so that
    positive values tie: the input's gradient is JAX's, bit for bit."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import max_pool as jax_max_pool

    jax, jnp = jx
    x = np.round(np.maximum(rand((4, 32, 32, 64), 21), 0.0) * 4) / 4
    windows = x.reshape(4, 16, 2, 16, 2, 64).transpose(0, 1, 3, 5, 2, 4).reshape(-1, 4)
    tied = (windows == windows.max(axis=1, keepdims=True)).sum(axis=1) > 1
    assert (tied & (windows.max(axis=1) > 0)).sum() > 1000  # positive maxima tie
    ct = rand((4, 16, 16, 64), 22)
    y, vjp = jax.vjp(jax_max_pool, jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    xt = torch.from_numpy(x.astype(np.float32)).bfloat16().requires_grad_()
    got = blocks.max_pool(xt)
    got.backward(torch.from_numpy(ct).bfloat16())
    np.testing.assert_array_equal(got.float().detach().numpy(), np.asarray(y, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want, np.float32))


# name -> (Cin, Cout, kernel, stride, padding, dilation, groups, H, W): MiniSeg's grouped convs
GROUPED = {"attention_1x1_g4": (24, 4, 1, 1, 0, 1, 4, 6, 5), "out_1x1_g4": (24, 32, 1, 1, 0, 1, 4, 6, 5),
           "depthwise_k3_d2": (6, 6, 3, 1, 2, 2, 6, 7, 9), "depthwise_k5_s2": (8, 8, 5, 2, 2, 1, 8, 9, 8),
           "depthwise_k3_s2_d4": (6, 6, 3, 2, 4, 4, 6, 11, 10)}


@pytest.mark.parametrize("name", GROUPED)
def test_grouped_conv_matches_jax(jx, name):
    """``TorchConv(groups=g)`` (weight [k, k, Cin / g, Cout]) against the
    JAX ``TorchConv(groups=g)``, without bias as MiniSeg's; a grouped conv
    never takes the hand kernel's or the dense matmul's route."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import TorchConv as J

    cin, cout, k, s, p, d, g, h, w = GROUPED[name]
    port = blocks.TorchConv(cin, cout, ndim=2, kernel_size=k, stride=s, padding=p, dilation=d, use_bias=False,
                            groups=g)
    assert port.weight.shape == (k, k, cin // g, cout) and not port.hand_kernel and not port.pointwise
    jax_module = J(features=cout, kernel_size=k, stride=s, padding=p, dilation=d, groups=g, use_bias=False)
    dy, dx, dw = against_jax(jx, jax_module, port, rand((2, h, w, cin), 3))
    assert dy <= 1e-5 and dx <= 1e-5 and dw <= 1e-5


def _vjp_against_jax(jx, jax_fn, port_fn, x, seed):
    """(max |output difference|, max |input gradient difference|) of the
    port's function against JAX's for a seeded cotangent."""
    jax, jnp = jx
    y, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    ct = rand(y.shape, seed)
    (g,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    got = port_fn(xt)
    assert tuple(got.shape) == tuple(y.shape)
    (got * torch.from_numpy(ct)).sum().backward()
    return float(np.abs(got.detach().numpy() - np.asarray(y)).max()), float(np.abs(xt.grad.numpy() - np.asarray(g)).max())


@pytest.mark.parametrize("shape, stride", [((2, 7, 8, 3), 1), ((2, 9, 8, 3), 2), ((1, 5, 4, 6, 2), 2)])
def test_avg_pool_matches_jax_at_the_borders(jx, shape, stride):
    """MiniSeg's k3 average pool with padding 1 at strides 1 and 2 (and a
    3-D case): the border windows hold padded cells, which flax and torch
    both count as zeros of a full window."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import avg_pool as jax_avg_pool

    dy, dx = _vjp_against_jax(jx, lambda t: jax_avg_pool(t, 3, stride=stride, padding=1),
                              lambda t: blocks.avg_pool(t, 3, stride, 1), rand(shape, 4), 5)
    assert dy <= 1e-6 and dx <= 1e-6


@pytest.mark.parametrize("hw, size", [((4, 4), 6), ((4, 4), 3), ((5, 7), 3), ((16, 16), 6), ((4, 4), 1)])
def test_adaptive_avg_pool_matches_jax(jx, hw, size):
    """PSPNet's pyramid pools: floor / ceil segments, overlapping where the
    size does not divide the input, and 6 cells from 4 at the tests' 32^2
    slices (each input cell in one or two segments)."""
    from general_medical_image_segmentation_cnn_framework_tpu.models.two_d.pspnet import adaptive_avg_pool2d as J

    dy, dx = _vjp_against_jax(jx, lambda t: J(t, size), lambda t: blocks.adaptive_avg_pool2d(t, size),
                              rand((2, *hw, 3), 6), 7)
    assert dy <= 1e-6 and dx <= 1e-6


@pytest.mark.parametrize("hw, size", [((6, 6), (4, 4)), ((3, 3), (4, 4)), ((7, 9), (3, 4)), ((2, 2), (4, 4)),
                                      ((1, 1), (4, 4))])
def test_resize_linear_to_a_shape_matches_jax(jx, hw, size):
    """``resize_linear`` to a shape where it downsamples (PSPNet's 6 -> 4 at
    32^2 slices; 7x9 -> 3x4) and upsamples (its 3, 2 and 1 -> 4):
    ``jax.image.resize`` 'linear' without antialiasing, values and the
    input's gradient."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn import blocks as jb

    dy, dx = _vjp_against_jax(jx, lambda t: jb.resize_linear(t, shape=size),
                              lambda t: blocks.resize_linear(t, shape=size), rand((2, *hw, 3), 8), 9)
    assert dy <= 1e-6 and dx <= 1e-5


@pytest.mark.parametrize("channels", [1, 24])
def test_prelu_matches_jax(jx, channels):
    """MiniSeg's per-channel PReLU (one slope a channel) and PSPNet's
    single slope, on values of both signs: output, input and slope
    gradients."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import PReLU as J

    dy, dx, dw = against_jax(jx, J(num_parameters=channels), blocks.PReLU(channels), rand((2, 5, 6, 24), 10))
    assert dy <= 1e-6 and dx <= 1e-6 and dw <= 1e-6


def test_fcn2d_upscore_init_matches_jax(jx):
    """FCN32s's ``upscore_kernel`` starts as the JAX package's
    ``_bilinear_kernel_init_2d`` (k64, the bilinear filter on each class's
    own channel pair), bit for bit."""
    from general_medical_image_segmentation_cnn_framework_tpu.models.two_d import fcn2d as jax_fcn2d
    from general_medical_image_segmentation_cnn_framework_tpu_torch.models.two_d.fcn2d import FCN32s

    want = np.asarray(jax_fcn2d._bilinear_kernel_init_2d(None, (64, 64, 2, 2)))
    np.testing.assert_array_equal(FCN32s(1, 2).upscore_kernel.detach().numpy(), want)
