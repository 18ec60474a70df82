"""The port's on-device augmentation (``data/device_aug.py``) against the JAX
package's, function by function, with the same seeded numpy inputs and the
same explicit parameters (coefficients, matrix, control grid, noise std,
flip bit), f32 on the CPU; and, as ``tests/test_device_aug.py`` holds the
JAX module, against the port's host transforms and scipy. Limits: fields
and displacements 1e-5, resampled images 1e-4, labels equal on at least
99.9% of the voxels and binary (a nearest-neighbour tie at an exact .5
coordinate may round another way in scipy)."""

import numpy as np
import pytest
import torch
from scipy import ndimage
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.scipy.ndimage import map_coordinates  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu.data import device_aug as jax_aug  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import device_aug as aug  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import transforms as host  # noqa: E402

SHAPE = (12, 13, 14)


@pytest.fixture()
def pair():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(1, *SHAPE)).astype(np.float32)
    gt = (rng.uniform(size=(1, *SHAPE)) > 0.6).astype(np.float32)
    return src, gt


def _t(a):
    return torch.from_numpy(np.array(a))


def _coeffs(seed):
    o = 4
    a, b, c = np.meshgrid(*(np.arange(o),) * 3, indexing="ij")
    return np.where(a + b + c <= 3, np.random.default_rng(seed).uniform(-0.5, 0.5, (o, o, o)), 0).astype(np.float32)


def _grid(seed, scale=4.0):
    n = 7
    grid = np.zeros((3, n, n, n), np.float32)
    grid[:, 2:-2, 2:-2, 2:-2] = np.random.default_rng(seed).uniform(-scale, scale, (3, n - 4, n - 4, n - 4))
    return grid


def _affine(src_shape, degrees=(8.0, -5.0, 3.0), translation=(0.0, 0.0, 0.0)):
    center = (np.asarray(src_shape, np.float32) - 1) / 2
    return (np.array([0.95, 1.05, 1.0], np.float32), np.array(degrees, np.float32),
            np.array(translation, np.float32), center)


def _labels_agree(got, want):
    assert set(np.unique(got).tolist()) <= {0.0, 1.0}
    agree = np.mean(got == want)
    assert agree >= 0.999, f"label agreement {agree}"


def test_bias_field_matches_jax_and_the_monomials():
    coeffs = _coeffs(3)
    got = aug.bias_field_from_coeffs(_t(coeffs), SHAPE).numpy()
    want = np.asarray(jax_aug.bias_field_from_coeffs(jnp.asarray(coeffs), SHAPE))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    x, y, z = np.meshgrid(*[np.linspace(-1.0, 1.0, s) for s in SHAPE], indexing="ij")
    poly = sum(coeffs[a, b, c] * x**a * y**b * z**c for a in range(4) for b in range(4) for c in range(4))
    np.testing.assert_allclose(got, np.exp(poly), rtol=2e-5, atol=2e-5)


def test_znormalize_matches_jax_and_the_host(pair):
    src, _ = pair
    got = aug.znormalize(_t(src)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_aug.znormalize(jnp.asarray(src))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, host.ZNormalization().normalize_array(src), rtol=1e-5, atol=1e-5)
    assert np.array_equal(aug.znormalize(torch.full((1, 2, 2, 2), 3.0)).numpy(), np.zeros((1, 2, 2, 2), np.float32))


def test_noise_with_a_fixed_std_is_the_generators_normal_draws(pair):
    """random_noise draws its std, then the field: with a range of one value
    the added field is that std times the generator's normals (JAX's adds
    std * normal the same way)."""
    src, _ = pair
    gen = torch.Generator().manual_seed(4)
    got = aug.random_noise(gen, _t(src), (0.2, 0.2)) - _t(src)
    gen = torch.Generator().manual_seed(4)
    torch.rand((), generator=gen)
    want = 0.2 * torch.randn(src.shape, generator=gen)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("translation", [(0.0, 0.0, 0.0), (0.5, -1.0, 0.0)])
def test_affine_matrix_matches_jax_and_the_host(translation):
    args = _affine((11.0, 12.0, 13.0), (7.0, -4.0, 2.5), translation)
    got = aug.affine_matrix(*map(_t, args)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_aug.affine_matrix(*map(jnp.asarray, args))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, host._affine_matrix(*(a.astype(np.float64) for a in args)), rtol=1e-5, atol=1e-5)


def test_affine_resample_matches_jax_and_scipy(pair):
    src, gt = pair
    m = np.asarray(jax_aug.affine_matrix(*map(jnp.asarray, _affine(SHAPE))))
    got_src, got_gt = (t.numpy() for t in aug.affine_resample_pair(_t(src), _t(gt), _t(m)))
    want_src, want_gt = (np.asarray(t) for t in jax_aug.affine_resample_pair(jnp.asarray(src), jnp.asarray(gt),
                                                                            jnp.asarray(m)))
    np.testing.assert_allclose(got_src, want_src, rtol=1e-4, atol=1e-4)
    _labels_agree(got_gt, want_gt)
    m_inv = np.linalg.inv(m.astype(np.float64))
    scipy_src = ndimage.affine_transform(src[0], m_inv[:3, :3], offset=m_inv[:3, 3], order=1, mode="constant",
                                         cval=float(src.min()))
    scipy_gt = ndimage.affine_transform(gt[0], m_inv[:3, :3], offset=m_inv[:3, 3], order=0, mode="constant")
    np.testing.assert_allclose(got_src[0], scipy_src, rtol=1e-4, atol=1e-4)
    _labels_agree(got_gt[0], scipy_gt)


def test_affine_resample_pads_with_the_minimum_and_zero(pair):
    """A translation past the volume: every sample outside [0, n - 1] is
    exactly the pad value (never a blend with the edge)."""
    src, gt = pair
    m = aug.affine_matrix(*map(_t, _affine(SHAPE, (0.0, 0.0, 0.0), (30.0, 0.0, 0.0))))
    out_src, out_gt = aug.affine_resample_pair(_t(src), _t(gt), m)
    assert torch.equal(out_src, torch.full_like(out_src, float(src.min()))) and not out_gt.any()


def test_elastic_displacement_matches_jax_and_the_host():
    grid = _grid(5, 7.5)
    got = aug.elastic_displacement(_t(grid), SHAPE).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_aug.elastic_displacement(jnp.asarray(grid), SHAPE)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, host.RandomElasticDeformation().displacement_field(grid.astype(np.float64), SHAPE),
                               rtol=1e-5, atol=1e-5)


def test_elastic_resample_matches_jax_and_scipy(pair):
    src, gt = pair
    grid = _grid(6)
    got_src, got_gt = (t.numpy() for t in aug.elastic_resample_pair(_t(src), _t(gt), _t(grid)))
    want_src, want_gt = (np.asarray(t) for t in jax_aug.elastic_resample_pair(jnp.asarray(src), jnp.asarray(gt),
                                                                             jnp.asarray(grid)))
    np.testing.assert_allclose(got_src, want_src, rtol=1e-4, atol=1e-4)
    _labels_agree(got_gt, want_gt)
    disp = host.RandomElasticDeformation().displacement_field(grid.astype(np.float64), SHAPE)
    coords = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in SHAPE], indexing="ij")
    sample = [coords[i] + disp[i] for i in range(3)]
    np.testing.assert_allclose(got_src[0], ndimage.map_coordinates(src[0], sample, order=1, mode="nearest"),
                               rtol=1e-4, atol=1e-4)
    _labels_agree(got_gt[0], ndimage.map_coordinates(gt[0], sample, order=0, mode="nearest"))


@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_nearest_rounds_half_away_from_zero_as_jax(mode):
    """At exact .5 coordinates (and -0.5, 4.5 at the edges) the order-0
    sample is JAX's: round half away from zero, then clamp; torch.round and
    grid_sample round half to even. In mode 'constant' a coordinate outside
    [0, n - 1] gives cval."""
    vol = np.broadcast_to(np.arange(5, dtype=np.float32)[:, None, None], (5, 3, 3))[None].copy()
    coords = np.ones((3, 7, 3, 3), np.float32)
    coords[0] = np.array([0.5, 1.5, 2.5, 3.5, -0.5, 4.5, -0.4], np.float32)[:, None, None]
    got = aug.resample(_t(vol), _t(coords), order=0, mode=mode, cval=-9.0).numpy()[0, :, 1, 1]
    want = np.asarray(map_coordinates(jnp.asarray(vol[0]), [jnp.asarray(c) for c in coords], order=0,
                                      mode="nearest"))[:, 1, 1]
    if mode == "constant":
        want = np.where((coords[0, :, 1, 1] >= 0) & (coords[0, :, 1, 1] <= 4), want, -9.0)
    assert want.tolist() == ([1.0, 2.0, 3.0, 4.0, 0.0, 4.0, 0.0] if mode == "nearest"
                             else [1.0, 2.0, 3.0, 4.0, -9.0, -9.0, -9.0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flip", [False, True])
def test_flip_matches_jax(flip):
    src = np.arange(24.0, dtype=np.float32).reshape(1, 2, 3, 4)
    gt = (src > 11).astype(np.float32)
    p = 1.0 if flip else 0.0  # the bit, fixed: a draw in [0, 1) is below 1 and not below 0
    got = aug.random_flip_pair(torch.Generator().manual_seed(0), _t(src), _t(gt), p=p)
    want = jax_aug.random_flip_pair(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(gt), p=p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[0].numpy(), src[:, ::-1] if flip else src)


def test_drawn_parameters_stay_in_tio_ranges():
    gen = torch.Generator().manual_seed(7)
    a, b, c = np.meshgrid(*(np.arange(4),) * 3, indexing="ij")
    for _ in range(20):
        coeffs = aug.bias_coefficients(gen).numpy()
        assert np.abs(coeffs).max() <= 0.5 and not coeffs[a + b + c > 3].any()
        scales, degrees, translation = (t.numpy() for t in aug.affine_params(gen))
        assert ((0.9 <= scales) & (scales <= 1.1)).all() and (np.abs(degrees) <= 10).all()
        assert not translation.any()
        grid = aug.elastic_grid(gen).numpy()
        assert np.abs(grid).max() <= 7.5 and np.abs(grid[:, 2:5, 2:5, 2:5]).min() > 0
        inner = np.zeros((7, 7, 7), bool)
        inner[2:5, 2:5, 2:5] = True
        assert not grid[:, ~inner].any()
        noise = (aug.random_noise(gen, torch.zeros(1, 16, 16, 16)) ** 2).mean().sqrt().item()
        assert 0.0 <= noise <= 0.25 * 1.1


def test_one_of_picks_affine_four_times_in_five():
    gen = torch.Generator().manual_seed(8)
    share = np.mean([aug.choose_affine(gen) for _ in range(400)])
    assert abs(share - 0.8) <= 0.05, share


def test_augment_pair_runs_the_chosen_branch_and_repeats_with_the_same_seed(pair, monkeypatch):
    src, gt = pair
    out = [aug.augment_pair(torch.Generator().manual_seed(s), _t(src), _t(gt)) for s in (1, 1, 2)]
    for s, g in out:
        assert s.shape == src.shape and g.shape == gt.shape and s.dtype == torch.float32
        assert torch.isfinite(s).all() and set(g.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert not torch.equal(out[0][0], out[2][0])
    ran = []
    for name in ("random_affine_pair", "random_elastic_pair"):
        real = getattr(aug, name)
        monkeypatch.setattr(aug, name, lambda *a, _n=name, _f=real: ran.append(_n) or _f(*a))
    for seed in range(6):
        ran.clear()
        gen = torch.Generator().manual_seed(seed)
        aug.augment_pair(gen, _t(src), _t(gt))
        assert len(ran) == 1  # one branch runs, the chosen one
