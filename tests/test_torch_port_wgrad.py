"""The port's conv weight gradient and train-mode conv against the JAX
package's, on the same numpy-seeded inputs, plus the tiled Pallas conv
(kernel #4) against the port's conv plain version.

On the CPU, ``conv3d_wgrad`` and ``conv3d_k3s1`` run the kernels' plain
versions. ``conv3d_wgrad`` is held to the Pallas ``wgrad_tapcols_tlayout``
in interpret mode (W = 128, the only width it takes) and to the XLA
``_wgrad_tlayout`` at a small odd shape; ``conv3d_k3s1``'s three gradients
to ``jax.grad`` of ``pallas_conv.pallas_conv3d`` (interpret mode) plus a
bias. Tolerances are f32 summation order: 1e-4 relative to the largest
magnitude.

The CUDA kernel runs only on a card: the ``cuda``-marked cases skip
without one; on the card, ``python -m pytest --noconftest
tests/test_torch_port_wgrad.py -m cuda``.
"""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.conv3d_bn_relu import (
    conv3d_bn_relu,
    conv3d_bn_relu_reference,
    conv3d_input_grad,
    conv3d_input_grad_reference,
    conv3d_k3s1,
    conv_split_k,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.conv3d_bn_relu import tile_n as conv_tile_n
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.conv3d_wgrad import (
    conv3d_wgrad,
    conv3d_wgrad_reference,
    output_tiles,
    split_k,
)

# (Cin, Cout, grid side) of the 18 convs of UNet3D at 16 x 64^3 and of UNet2D at 16 x 128^2
UNET3D_CONVS = [
    (1, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16), (128, 128, 16),
    (128, 256, 8), (256, 256, 8), (256, 512, 4), (512, 512, 4), (512, 256, 8), (256, 256, 8),
    (256, 128, 16), (128, 128, 16), (128, 64, 32), (64, 64, 32), (64, 32, 64), (32, 32, 64),
]
UNET2D_CONVS = [
    (1, 64, 128), (64, 64, 128), (64, 128, 64), (128, 128, 64), (128, 256, 32), (256, 256, 32),
    (256, 512, 16), (512, 512, 16), (512, 512, 8), (512, 512, 8), (1024, 256, 16), (256, 256, 16),
    (512, 128, 32), (128, 128, 32), (256, 64, 64), (64, 64, 64), (128, 64, 128), (64, 64, 128),
]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(1.0, np.abs(want).max())


def test_wgrad_matches_pallas_tapcols_interpret(monkeypatch):
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu.ops import pallas_tlayout as ptl

    monkeypatch.setattr(ptl, "_INTERPRET", True)
    x, g = _rand((1, 3, 4, 128, 8), 1), _rand((1, 3, 4, 128, 8), 2)
    want = ptl.wgrad_tapcols_tlayout(ptl.to_tlayout(jnp.asarray(x)), ptl.to_tlayout(jnp.asarray(g)), bh=2)
    _close(conv3d_wgrad(torch.from_numpy(x), torch.from_numpy(g)).numpy(), want)


def test_wgrad_matches_xla_wgrad_at_an_odd_shape():
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu.ops import pallas_tlayout as ptl

    # D != H != W and asymmetric data: a layout wrong in one of dz/dy/dx fails
    x, g = _rand((2, 3, 5, 7, 3), 3), _rand((2, 3, 5, 7, 4), 4)
    want = ptl._wgrad_tlayout(ptl.to_tlayout(jnp.asarray(x)), ptl.to_tlayout(jnp.asarray(g)))
    got = conv3d_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, 3, 4)
    _close(got.numpy(), np.asarray(want).transpose(1, 2, 4, 0, 3))


def test_conv3d_k3s1_gradients_match_pallas_conv3d_vjp(monkeypatch):
    import jax
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu.ops import pallas_conv

    monkeypatch.setattr(pallas_conv, "_INTERPRET", True)
    x, k = _rand((2, 4, 6, 5, 3), 5), _rand((3, 3, 3, 3, 8), 6, scale=0.2)
    b, ct = _rand((8,), 7), _rand((2, 4, 6, 5, 8), 8)

    def jax_loss(x, k, b):
        return jnp.sum((pallas_conv.pallas_conv3d(x, k) + b) * ct)

    want_y = pallas_conv.pallas_conv3d(jnp.asarray(x), jnp.asarray(k)) + b
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    y = conv3d_k3s1(xt, kt, bt)
    (y * torch.from_numpy(ct)).sum().backward()
    _close(y.detach().numpy(), want_y)
    for got, w in zip((xt.grad, kt.grad, bt.grad), want):
        _close(got.numpy(), w)


def test_stem_takes_no_input_gradient():
    x = torch.from_numpy(_rand((1, 3, 4, 5, 1), 9))  # data: needs no grad
    k = torch.from_numpy(_rand((3, 3, 3, 1, 4), 10)).requires_grad_()
    b = torch.zeros(4, requires_grad=True)
    conv3d_k3s1(x, k, b).sum().backward()
    assert x.grad is None and k.grad.shape == (3, 3, 3, 1, 4) and b.grad.shape == (4,)


def test_input_grad_on_cpu_is_conv3d_input_and_counts_nothing():
    # D != H != W, Cin != Cout, asymmetric weights: a flip or transpose missed on one axis fails
    g, w = torch.from_numpy(_rand((2, 3, 5, 4, 6), 22)), torch.from_numpy(_rand((3, 3, 3, 2, 6), 23))
    before = (conv3d_input_grad.launches, conv3d_bn_relu.launches)
    got = conv3d_input_grad(g, w)
    want = torch.nn.grad.conv3d_input(
        (2, 2, 3, 5, 4), w.permute(4, 3, 0, 1, 2), g.permute(0, 4, 1, 2, 3), padding=1
    ).permute(0, 2, 3, 4, 1)
    assert got.shape == (2, 3, 5, 4, 2) and (conv3d_input_grad.launches, conv3d_bn_relu.launches) == before
    _close(got.numpy(), want.numpy())
    torch.testing.assert_close(got, conv3d_input_grad_reference(g, w), rtol=0, atol=0)


def test_tiled_pallas_conv_matches_the_port_conv(monkeypatch):
    """Kernel #4 (``fused_conv3d_bn_relu_tiled``: Cout padded to 128,
    H-tiled) computes kernel #3's function, which the port's CUDA kernel
    ports; held here against that kernel's plain version."""
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu.ops import pallas_conv

    monkeypatch.setattr(pallas_conv, "_INTERPRET", True)
    x, k, b = _rand((1, 6, 16, 12, 3), 11), _rand((3, 3, 3, 3, 5), 12), _rand((5,), 13)
    got = pallas_conv.fused_conv3d_bn_relu_tiled(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), tile_h=8)
    assert got.shape == (1, 6, 16, 12, 128)
    want = conv3d_bn_relu_reference(*map(torch.from_numpy, (x, k, b))).numpy()
    np.testing.assert_allclose(np.asarray(got[..., :5]), want, rtol=1e-4, atol=1e-4)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    x, g = torch.from_numpy(_rand((1, 2, 3, 4, 2), 14)), torch.from_numpy(_rand((1, 2, 3, 4, 3), 15))
    before = conv3d_wgrad.launches
    torch.testing.assert_close(conv3d_wgrad(x, g), conv3d_wgrad_reference(x, g), rtol=0, atol=0)
    assert conv3d_wgrad(x.bfloat16(), g.bfloat16()).dtype == torch.float32
    assert conv3d_wgrad.launches == before
    for bad in ((x, g.bfloat16()), (x, g[:, :1].contiguous()), (x[0], g[0]), (x.transpose(2, 3), g)):
        with pytest.raises((TypeError, ValueError)):
            conv3d_wgrad(*bad)


@pytest.mark.parametrize(
    "nd,cin,cout,side", [(3, *c) for c in UNET3D_CONVS] + [(2, *c) for c in UNET2D_CONVS]
)
def test_wgrad_split_plan_covers_each_voxel_once_and_fills_the_card(nd, cin, cout, side):
    """The weight gradient's split plan at each UNet3D and UNet2D conv (batch
    16): the same on every call, splits of whole 64-voxel pipeline steps that
    cover every voxel exactly once, and at least one block per SM of an H100
    (132): the stem's kernel runs one block per split, the others
    output_tiles(rows, Cout) blocks per split."""
    voxels, rows = 16 * side**nd, (3 if nd == 3 else 1) * 9 * cin
    chunk, splits = split_k(rows, cout, voxels)
    assert split_k(rows, cout, voxels) == (chunk, splits)
    assert chunk % 64 == 0 and splits >= 1
    seen = np.zeros(voxels, dtype=np.int64)
    for z in range(splits):
        seen[z * chunk:min((z + 1) * chunk, voxels)] += 1
    assert (seen == 1).all()
    tiles = 1 if cin == 1 else output_tiles(rows, cout)[0]
    assert tiles * splits >= 132


@pytest.mark.parametrize(
    "nd,cin,cout,side,grad",
    [(nd, cin, cout, side, grad)
     for nd, convs in ((3, UNET3D_CONVS), (2, UNET2D_CONVS))
     for cin, cout, side in convs if cin > 1
     for grad in (False, True)],
)
def test_conv_split_plan_covers_each_k_once_and_fills_the_card(nd, cin, cout, side, grad):
    """The K split of the wgmma conv at each UNet3D and UNet2D conv (batch 16)
    and its input gradient (Cin and Cout swapped): the same on every call,
    chunks of whole 64-wide K steps that cover every K index exactly once,
    and at least one block per SM of an H100 (132) counting 128-voxel x
    conv_tile_n(Cout) output tiles times splits. The stem (Cin = 1) takes another
    variant."""
    if grad:
        cin, cout = cout, cin
    voxels, k = 16 * side**nd, (3 if nd == 3 else 1) * 9 * cin
    kchunk, splits = conv_split_k(voxels, k, cout)
    assert conv_split_k(voxels, k, cout) == (kchunk, splits)
    assert kchunk % 64 == 0 and splits >= 1
    seen = np.zeros(k, dtype=np.int64)
    for z in range(splits):
        seen[z * kchunk:min((z + 1) * kchunk, k)] += 1
    assert (seen == 1).all()
    assert -(-voxels // 128) * -(-cout // conv_tile_n(cout)) * splits >= 132


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape",
    [
        (1, 3, 5, 7, 1, 5),  # Cin = 1 stem, ragged Cout
        (2, 4, 6, 5, 3, 70),  # ragged rows and Cout over one tile
        (1, 2, 2, 2, 1, 1),
        (2, 5, 9, 11, 64, 136),  # ragged voxels, Cout over two tiles
        # Cin, Cout multiples of 8: the wgmma variants in bf16
        (1, 3, 5, 7, 8, 24),
        (2, 4, 6, 5, 32, 32),
        (3, 7, 3, 5, 16, 8),
        (4, 16, 16, 16, 32, 32),  # split into several voxel chunks
        (2, 4, 4, 4, 512, 512),  # the bottleneck's width
        # the wgmma variant's tile widths (bf16), ragged and asymmetric; 990 and 378
        # voxels are not multiples of its 64-voxel step
        (2, 5, 9, 11, 24, 40),  # 64 wide, ragged Cout, Cin != Cout
        (1, 6, 7, 9, 64, 24),  # 32 wide, ragged Cout, 14 row tiles
        (2, 6, 10, 7, 16, 136),  # 128 wide, Cout over two tiles
        (2, 8, 8, 8, 128, 256),  # 128 wide, two full tiles
        (2, 5, 9, 11, 8, 64),  # Cin = 8: one 8-row chunk per tap
        # the bf16 stem variant (Cin = 1, Cout a multiple of 8), one and several splits
        (2, 9, 10, 11, 1, 32),
        (3, 17, 16, 16, 1, 32),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.cuda
def test_cuda_wgrad_matches_plain_version(cuda_device, shape, dtype):
    n, d, h, w, cin, cout = shape
    x = torch.from_numpy(_rand((n, d, h, w, cin), 16)).to(cuda_device, dtype)
    g = torch.from_numpy(_rand((n, d, h, w, cout), 17)).to(cuda_device, dtype)
    before = conv3d_wgrad.launches
    got = conv3d_wgrad(x, g)
    again = conv3d_wgrad(x, g)
    torch.cuda.synchronize()
    assert conv3d_wgrad.launches == before + 2
    # the plain version in f64 on the same rounded inputs: the kernel's f32 summation only
    want = conv3d_wgrad_reference(x.double(), g.double())
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # the same on every run
    assert (got.double() - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize(
    "shape",
    [
        (1, 3, 5, 7, 1, 32),  # the stem's transposed shape: one output channel (ragged-Cout masking)
        (2, 4, 6, 5, 3, 70),  # ragged channels, Cin over one tile
        (2, 5, 9, 11, 64, 32),  # wgmma variant, 32-wide tile
        (2, 4, 4, 4, 512, 256),  # the bottleneck's width
        # the wgmma variant: K split at the 4^3 bottleneck, ragged and asymmetric widths
        (16, 4, 4, 4, 512, 512),
        (2, 5, 9, 11, 40, 24),
        (2, 4, 6, 5, 136, 16),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.cuda
def test_cuda_input_grad_matches_plain_version(cuda_device, shape, dtype):
    """The input gradient on the card against the plain version in f32 on
    the CPU (no TF32) from the same rounded inputs: 1e-4 in f32, 1e-2 in bf16
    (one rounding of the output), relative to max(1, max|plain|); it counts
    as its own kernel."""
    n, d, h, w, cin, cout = shape
    g = torch.from_numpy(_rand((n, d, h, w, cout), 24)).to(cuda_device, dtype)
    k = torch.from_numpy(_rand((3, 3, 3, cin, cout), 25, scale=(27 * cout) ** -0.5)).to(cuda_device, dtype)
    before = (conv3d_input_grad.launches, conv3d_bn_relu.launches)
    got = conv3d_input_grad(g, k)
    torch.cuda.synchronize()
    assert (conv3d_input_grad.launches, conv3d_bn_relu.launches) == (before[0] + 1, before[1])
    want = conv3d_input_grad_reference(g.float().cpu(), k.float().cpu())
    assert got.dtype == dtype and got.shape == (n, d, h, w, cin)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (got.float().cpu() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.cuda
def test_cuda_conv3d_k3s1_gradients_match_the_cpu(cuda_device, dtype):
    """Forward, dgrad (the forward kernel on flipped, transposed weights) and
    wgrad on the card against the plain versions on the CPU, from the same
    rounded inputs; bf16 outputs are rounded once, so 1e-2 there."""
    x = torch.from_numpy(_rand((2, 5, 6, 7, 16), 18)).to(dtype)
    k = torch.from_numpy(_rand((3, 3, 3, 16, 24), 19, scale=0.1))
    b, ct = torch.from_numpy(_rand((24,), 20)), torch.from_numpy(_rand((2, 5, 6, 7, 24), 21)).to(dtype)
    grads = []
    for device in (torch.device("cpu"), cuda_device):
        xt, kt, bt = (t.to(device).detach().requires_grad_() for t in (x, k, b))
        y = conv3d_k3s1(xt, kt, bt)
        y.backward(ct.to(device))
        grads.append([t.detach().float().cpu() for t in (y, xt.grad, kt.grad, bt.grad)])
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want in zip(grads[1], grads[0]):
        assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
