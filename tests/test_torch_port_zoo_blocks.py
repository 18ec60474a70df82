"""The blocks that SkipDenseNet3D, FCN3D, SegNet and UNet++
add to the port, against the JAX package's on the CPU in f32 (outputs and,
through ``jax.vjp`` and autograd, input and parameter gradients, with
``torch_port_zoo3d.py``'s helpers; every kernel a seeded random draw, so
no flip symmetry hides a wrong orientation): the general
``TorchConvTranspose`` (kernel != stride, padding; 3-D and 2-D), SkipDenseNet3D's
grouped one, FCN3D's ``_BilinearDeconv`` and its bilinear init, the
ceil-mode max pool and SegNet's masked pool and unpool on inputs full of
ties, and ``resize_linear`` upsampling."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d import densenet3d, fcn3d
from general_medical_image_segmentation_cnn_framework_tpu_torch.nn import blocks
from torch_port_zoo3d import against_jax, jx, rand  # noqa: F401 (jx: a fixture)

# name -> (Cin, Cout, kernel, stride, padding, input's spatial shape)
TRANSPOSED = {"k4s2p1_3d": (3, 5, 4, 2, 1, (4, 5, 3)), "k6s4p1_3d": (4, 2, 6, 4, 1, (3, 2, 3)),
              "k3s2p1_2d": (3, 5, 3, 2, 1, (5, 6))}


@pytest.mark.parametrize("name", TRANSPOSED)
def test_general_transposed_conv_matches_jax(jx, name):
    """torch's output size (in - 1) * stride - 2 * padding + kernel, with a bias."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import TorchConvTranspose as J

    cin, cout, k, s, p, shape = TRANSPOSED[name]
    port = blocks.TorchConvTranspose(cin, cout, kernel_size=k, stride=s, padding=p, ndim=len(shape))
    assert not port.matmul
    dy, dx, dw = against_jax(jx, J(features=cout, kernel_size=k, stride=s, padding=p), port,
                             rand((2, *shape, cin), 1))
    assert dy <= 1e-5 and dx <= 1e-5 and dw <= 1e-5


@pytest.mark.parametrize("level", [0, 2])
def test_grouped_transposed_conv_matches_jax(jx, level):
    """SkipDenseNet3D's heads (kernel 2^(i+1) + 2, stride 2^(i+1), padding
    1, groups = classes = 2): one grouped transposed conv against the JAX
    package's two per-group ``TorchConvTranspose`` scopes."""
    from general_medical_image_segmentation_cnn_framework_tpu.models.three_d.densenet3d import _GroupedConvTranspose as J

    s = 2 ** (level + 1)
    port = densenet3d._GroupedConvTranspose(6, 2, 2, s + 2, s, 1, torch.float32, "kaiming", None)
    assert port.weight.shape == (s + 2,) * 3 + (6, 1)
    jax_module = J(features=2, groups=2, kernel_size=s + 2, stride=s, padding=1)
    dy, dx, dw = against_jax(jx, jax_module, port, rand((2, 3, 2, 3, 6), 2))
    assert dy <= 1e-5 and dx <= 1e-5 and dw <= 1e-5


@pytest.mark.parametrize("k, s", [(4, 2), (16, 8)])
def test_bilinear_deconv_matches_jax(jx, k, s):
    """FCN3D's VALID transposed conv: its bilinear init equals the JAX
    package's ``bilinear_kernel_init``; with random weights its output and
    gradients match."""
    from general_medical_image_segmentation_cnn_framework_tpu.models.three_d import fcn3d as jax_fcn3d

    jax, jnp = jx
    port = fcn3d._BilinearDeconv(2, 3, k, s, torch.float32, None)
    np.testing.assert_array_equal(port.weight.detach().numpy(),
                                  np.asarray(jax_fcn3d.bilinear_kernel_init(None, (k,) * 3 + (2, 3))))
    dy, dx, dw = against_jax(jx, jax_fcn3d._BilinearDeconv(features=3, kernel_size=k, stride=s), port,
                             rand((2, 3, 2, 4, 2), 3))
    assert dy <= 1e-5 and dx <= 1e-5 and dw <= 1e-5


def _vjp_against_jax(jx, jax_fn, port_fn, x, n_out, seed):
    """(max |output difference|, max |input gradient difference|) of the
    port's function against JAX's for seeded cotangents of each output."""
    jax, jnp = jx
    outs, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    outs = outs if isinstance(outs, tuple) else (outs,)
    cts = [rand(o.shape, seed + i) for i, o in enumerate(outs)]
    (g,) = vjp(tuple(map(jnp.asarray, cts)) if n_out > 1 else jnp.asarray(cts[0]))
    xt = torch.from_numpy(x).requires_grad_()
    got = port_fn(xt)
    got = got if isinstance(got, tuple) else (got,)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, cts)).backward()
    dy = max(float(np.abs(o.detach().numpy() - np.asarray(w)).max()) for o, w in zip(got, outs))
    return dy, float(np.abs(xt.grad.numpy() - np.asarray(g)).max())


def test_ceil_pool_matches_jax_with_ties(jx):
    """FCN3D's ceil-mode 2x max pool on odd sizes (5, 6, 7) of integer
    values in {0, 1, 2} (most windows tie): the same values, and each
    window's gradient on the same one of its maxima."""
    from general_medical_image_segmentation_cnn_framework_tpu.models.three_d.fcn3d import _ceil_pool

    x = np.random.default_rng(4).integers(0, 3, size=(2, 5, 6, 7, 3)).astype(np.float32)
    assert blocks.max_pool_ceil(torch.from_numpy(x)).shape == (2, 3, 3, 4, 3)
    dy, dx = _vjp_against_jax(jx, _ceil_pool, blocks.max_pool_ceil, x, 1, 5)
    assert dy == 0 and dx == 0


def test_masked_pool_and_unpool_match_jax_with_ties(jx):
    """SegNet's pool with its one-hot mask and the unpool through it, on
    integer values in {0, 1, 2}: the pooled values, the mask (the first
    maximum of each window), the unpooled map of 2 x the pooled values, and
    the input's gradient through both outputs (a tie's share split evenly
    by the max, as ``jnp.max``)."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn import blocks as jb

    def both(pool, unpool):
        def f(x):
            pooled, mask = pool(x)
            return pooled, unpool(2 * pooled, mask)
        return f

    x = np.random.default_rng(6).integers(0, 3, size=(2, 6, 8, 4)).astype(np.float32)
    mask = blocks.max_pool_with_mask(torch.from_numpy(x))[1].numpy()
    np.testing.assert_array_equal(mask, np.asarray(jb.max_pool_with_mask(jx[1].asarray(x))[1]))
    assert mask.sum(axis=3).min() == mask.sum(axis=3).max() == 1
    dy, dx = _vjp_against_jax(jx, both(jb.max_pool_with_mask, jb.max_unpool_with_mask),
                              both(blocks.max_pool_with_mask, blocks.max_unpool_with_mask), x, 2, 7)
    assert dy == 0 and dx <= 1e-6


@pytest.mark.parametrize("shape, scale, size", [((2, 5, 7, 3), 2, None), ((2, 4, 6, 2), None, (9, 13)),
                                                ((1, 3, 4, 5, 2), 2, None)])
def test_resize_linear_upsampling_matches_jax(jx, shape, scale, size):
    """Bi- and trilinear upsampling with half-pixel centres (UNet++'s final
    resize to the input's size): values and the input's gradient."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn import blocks as jb

    x = rand(shape, 8)
    kw = {"shape": size} if size else {"scale": scale}
    dy, dx = _vjp_against_jax(jx, lambda t: jb.resize_linear(t, **kw), lambda t: blocks.resize_linear(t, **kw), x, 1, 9)
    assert dy <= 1e-6 and dx <= 1e-5
