"""More of the blocks the port's 3-D zoo adds, against the JAX package's on
the CPU in f32, with ``torch_port_zoo3d.py``'s helpers:
``resize_nearest`` and the pools, ``SEResidual`` and ``SEInception``, and
``ConvBlock``'s norm / activation / kernel variants in train and eval
mode; and FusionNet, built of UNet3D's and V-Net's blocks and two fusion
ConvBlocks, by its eval logits (4 and 4 around the fixed-width V-Net, 16^3,
the JAX side on XLA's native conv route, which compiles faster)."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch.nn import blocks, residual
from torch_port_zoo3d import against_jax, check_eval_logits, jx, rand  # noqa: F401 (jx: a fixture)


def test_resize_nearest_and_pools_match_jax(jx):
    """``resize_nearest`` (one scale and per-axis scales), ``global_avg_pool``
    and ``max_pool`` (window = stride, and a general window / stride /
    padding) against the JAX package's."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn import blocks as jb

    jax, jnp = jx
    x = rand((2, 5, 6, 7, 3), 3)
    for fn, port in ((lambda t: jb.resize_nearest(t, 2), lambda t: blocks.resize_nearest(t, 2)),
                     (lambda t: jb.resize_nearest(t, (1, 2, 3)), lambda t: blocks.resize_nearest(t, (1, 2, 3))),
                     (jb.global_avg_pool, blocks.global_avg_pool),
                     (lambda t: jb.max_pool(t, 2), lambda t: blocks.max_pool(t, 2)),
                     (lambda t: jb.max_pool(t, 3, 2, 1), lambda t: blocks.max_pool(t, 3, 2, 1))):
        want = np.asarray(fn(jnp.asarray(x)))
        got = port(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["SEResidual", "SEInception"])
def test_squeeze_excite_matches_jax(jx, name):
    from general_medical_image_segmentation_cnn_framework_tpu.nn import residual as jax_residual

    x = rand((2, 4, 5, 6, 32), 5)
    dy, dx, dw = against_jax(jx, getattr(jax_residual, name)(), getattr(residual, name)(32), x)
    assert dy <= 1e-6 and dx <= 1e-5 and dw <= 1e-5


# ConvBlock variants: (kernel_size, padding, norm, act)
BLOCKS = {"instance_leaky_relu": (3, 1, "instance", "leaky_relu"), "k5_none_prelu": (5, 2, "none", "prelu"),
          "k1_batch_elu": (1, 0, "batch", "elu")}


@pytest.mark.parametrize("name", BLOCKS)
@pytest.mark.parametrize("train", [True, False])
def test_convblock_variants_match_jax(jx, name, train):
    """``ConvBlock``'s norm, activation and kernel variants (the k3 s1 p1
    one on the hand kernels), in train mode (batch statistics) and eval."""
    from general_medical_image_segmentation_cnn_framework_tpu.nn.blocks import ConvBlock as J

    k, p, norm, act = BLOCKS[name]
    x = rand((2, 6, 5, 7, 4), 8)
    port = blocks.ConvBlock(4, 6, kernel_size=k, padding=p, norm=norm, act=act).train(train)
    dy, dx, dw = against_jax(jx, J(features=6, kernel_size=k, padding=p, norm=norm, act=act), port, x,
                              mutable=train, train=train)
    assert dy <= 1e-5 and dx <= 1e-4 and dw <= 1e-4


def test_fusionnet_eval_logits_match_jax(jx):
    check_eval_logits("fusionnet", native=True)
