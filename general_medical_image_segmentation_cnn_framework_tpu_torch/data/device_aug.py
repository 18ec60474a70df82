"""On-device data augmentation: the reference's TorchIO training transform
stack as tensor code on the volume's device.

The counterpart of the JAX package's ``data/device_aug.py``: the same
transform family as the host pipeline (``data/transforms.py``):
RandomBiasField -> ZNormalization -> RandomNoise -> RandomFlip(axis 0) ->
OneOf{RandomAffine 0.8, RandomElasticDeformation 0.2} (reference
dataloader.py:69-112), so ``data_backend=device`` with ``config.aug=true``
augments each volume on the card at its true shape, and ``epoch_scan``
re-augments its volume store there every epoch.

The functions keep the JAX names and take the same explicit parameters, so
a test can hand both packages the same coefficients, matrix, control grid
or flip bit. Volumes are channels-first ``[C, X, Y, Z]`` f32. The parameter
distributions are JAX's (and tio's); the draws come from an explicit
``torch.Generator`` on the volume's device, so the random stream is the
port's own. Interpolation is JAX's ``map_coordinates``: the floor / weight
/ clamp gathers of order 1 for the image, and for the label order 0, whose
nearest index rounds half away from zero (``torch.round`` and
``grid_sample`` round half to even).

Plain tensor code: the JAX module reaches no ``pallas_call``, so no kernel
is owed here.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from .transforms import _bspline_axis_matrix

Pair = Tuple[torch.Tensor, torch.Tensor]


def _uniform(generator: torch.Generator, shape: Sequence[int], low: float, high: float) -> torch.Tensor:
    """U(low, high) f32 draws on the generator's device."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return low + (high - low) * u


def bias_field_from_coeffs(coeffs: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """exp(poly) field from an [o, o, o] coefficient tensor (entries with
    exponent-sum > order are expected to be zero)."""
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32)
    o = coeffs.shape[0]
    powers = [
        torch.stack([torch.linspace(-1.0, 1.0, s, device=coeffs.device) ** e for e in range(o)])
        for s in shape
    ]
    return torch.exp(torch.einsum("abc,ax,by,cz->xyz", coeffs, *powers)).float()


def bias_coefficients(generator: torch.Generator, coefficients: float = 0.5, order: int = 3) -> torch.Tensor:
    """tio.RandomBiasField's draw: an [order+1]^3 cube of U(-c, c)
    coefficients, zero where the exponent sum exceeds ``order`` (a full cube
    keeps the draw count fixed, as JAX's)."""
    o = order + 1
    coeffs = _uniform(generator, (o, o, o), -coefficients, coefficients)
    a, b, c = torch.meshgrid(*(torch.arange(o, device=coeffs.device),) * 3, indexing="ij")
    return torch.where(a + b + c <= order, coeffs, torch.zeros((), device=coeffs.device))


def polynomial_bias_field(generator: torch.Generator, shape: Sequence[int], coefficients: float = 0.5,
                          order: int = 3) -> torch.Tensor:
    """exp(poly(order)) multiplicative bias field (tio.RandomBiasField)."""
    return bias_field_from_coeffs(bias_coefficients(generator, coefficients, order), shape)


def znormalize(vol: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the whole volume in f32, std with ddof 0
    (tio.ZNormalization, ``jnp.std``); a constant volume is only centred."""
    vol = vol.float()
    std = vol.std(correction=0)
    return (vol - vol.mean()) / torch.where(std == 0, torch.ones_like(std), std)


def random_noise(generator: torch.Generator, vol: torch.Tensor,
                 std_range: Tuple[float, float] = (0.0, 0.25)) -> torch.Tensor:
    """Additive Gaussian noise, std ~ U(std_range) (tio.RandomNoise)."""
    std = _uniform(generator, (), *std_range)
    noise = torch.randn(vol.shape, generator=generator, device=vol.device, dtype=torch.float32)
    return vol + std * noise


def affine_matrix(scales, degrees, translation, center) -> torch.Tensor:
    """4x4 voxel-space affine in f32: rotate (degrees, Rz @ Ry @ Rx) and
    scale about ``center``, then translate (``transforms._affine_matrix``)."""
    scales, degrees, translation, center = (
        torch.as_tensor(t, dtype=torch.float32) for t in (scales, degrees, translation, center)
    )
    dev = scales.device
    r = torch.deg2rad(degrees.to(dev))
    (cx, cy, cz), (sx, sy, sz) = r.cos(), r.sin()
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)

    def mat(rows):
        return torch.stack([torch.stack(row) for row in rows])

    rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    a = (rz @ ry @ rx) * scales[None, :]  # R @ diag(scales)
    center = center.to(dev)
    t = center - a @ center + translation.to(dev)
    m = torch.cat([a, t[:, None]], dim=1)
    return torch.cat([m, torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev)], dim=0)


def _identity_grid(shape: Sequence[int], device: torch.device) -> torch.Tensor:
    axes = [torch.arange(s, dtype=torch.float32, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))  # [3, X, Y, Z]


def _round_half_away_from_zero(x: torch.Tensor) -> torch.Tensor:
    r = torch.trunc(x)
    return r + torch.where((x - r).abs() >= 0.5, torch.sign(x), torch.zeros_like(x))


def _nodes(coord: torch.Tensor, order: int, size: int):
    """[(index clamped to [0, size - 1], weight)] of one axis, as JAX's
    ``_nearest_indices_and_weights`` / ``_linear_indices_and_weights`` under
    mode 'nearest'."""
    if order == 0:
        return [(_round_half_away_from_zero(coord).long().clamp(0, size - 1), None)]
    lower = torch.floor(coord)
    upper_weight = coord - lower
    index = lower.long()
    return [(index.clamp(0, size - 1), 1 - upper_weight), ((index + 1).clamp(0, size - 1), upper_weight)]


def resample(vol: torch.Tensor, coords: torch.Tensor, order: int, mode: str = "constant", cval=0.0) -> torch.Tensor:
    """Per-channel ``map_coordinates`` of order 0 or 1; vol [C, X, Y, Z],
    coords [3, X', Y', Z'] -> [C, X', Y', Z'] f32.

    mode 'nearest' clamps every index to the volume (scipy's and JAX's
    'nearest'); mode 'constant' reproduces scipy's semantics, as JAX's
    module does: a sample whose coordinate leaves [0, n - 1] on some axis is
    exactly ``cval``, never a blend of ``cval`` and the edge."""
    if mode not in ("constant", "nearest"):
        raise NotImplementedError(f"resample mode '{mode}' (constant | nearest)")
    vol = vol.float()
    sizes = vol.shape[1:]
    flat = vol.reshape(vol.shape[0], -1)
    out = None
    for corner in itertools.product(*(_nodes(coords[i], order, n) for i, n in enumerate(sizes))):
        (ix, wx), (iy, wy), (iz, wz) = corner
        value = flat[:, ((ix * sizes[1] + iy) * sizes[2] + iz).reshape(-1)].reshape(vol.shape[0], *ix.shape)
        if order == 1:
            value = (wx * wy * wz) * value
        out = value if out is None else out + value
    if mode == "constant":
        valid = torch.ones(coords.shape[1:], dtype=torch.bool, device=coords.device)
        for i, n in enumerate(sizes):
            valid &= (coords[i] >= 0) & (coords[i] <= n - 1)
        out = torch.where(valid[None], out, torch.as_tensor(cval, dtype=out.dtype, device=out.device))
    return out


def affine_resample_pair(src: torch.Tensor, gt: torch.Tensor, m: torch.Tensor) -> Pair:
    """Apply a 4x4 voxel-space affine ``m`` (output <- input through its f32
    inverse): linear for the image (padded with the source's minimum),
    nearest for the label (padded with 0)."""
    m_inv = torch.linalg.inv(torch.as_tensor(m, dtype=torch.float32).to(src.device))
    grid = _identity_grid(src.shape[1:], src.device)
    coords = torch.einsum("ij,jxyz->ixyz", m_inv[:3, :3], grid) + m_inv[:3, 3][:, None, None, None]
    out_src = resample(src, coords, order=1, mode="constant", cval=src.min())
    out_gt = torch.round(resample(gt, coords, order=0, mode="constant", cval=0.0))
    return out_src, out_gt


def affine_params(generator: torch.Generator, scales: float = 0.1, degrees: float = 10.0,
                  translation: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tio.RandomAffine's draw: scales U(1 - s, 1 + s), degrees U(-d, d),
    translation U(-t, t), each [3]."""
    sc = _uniform(generator, (3,), 1 - scales, 1 + scales)
    dg = _uniform(generator, (3,), -degrees, degrees)
    tr = _uniform(generator, (3,), -translation, translation)
    return sc, dg, tr


def random_affine_pair(generator: torch.Generator, src: torch.Tensor, gt: torch.Tensor, scales: float = 0.1,
                       degrees: float = 10.0, translation: float = 0.0) -> Pair:
    """tio.RandomAffine defaults: scale U(0.9, 1.1), rotation U(-10, 10)
    degrees, linear / nearest interpolation, pad value the source minimum
    (transforms.RandomAffine)."""
    sc, dg, tr = affine_params(generator, scales, degrees, translation)
    center = (torch.tensor(src.shape[1:], dtype=torch.float32, device=src.device) - 1) / 2.0
    return affine_resample_pair(src, gt, affine_matrix(sc, dg, tr, center))


@lru_cache(maxsize=None)
def _bspline_bases(shape: Tuple[int, int, int], num_cp: int) -> Tuple[np.ndarray, ...]:
    """Per-axis cubic B-spline basis matrices of ``transforms``, cached as
    small numpy constants (the JAX module caches numpy for its own reason:
    a cached traced array would poison later traces)."""
    return tuple(np.asarray(_bspline_axis_matrix(s, num_cp), np.float32) for s in shape)


def elastic_displacement(grid: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """[3, n, n, n] control coefficients -> [3, *shape] f32 voxel displacement
    (the ITK-mesh tensor-product cubic B-spline of
    ``transforms.RandomElasticDeformation.displacement_field``)."""
    grid = torch.as_tensor(grid, dtype=torch.float32)
    bx, by, bz = (torch.from_numpy(b).to(grid.device) for b in _bspline_bases(tuple(shape), grid.shape[1]))
    d = torch.einsum("xi,aijk->axjk", bx, grid)
    d = torch.einsum("yj,axjk->axyk", by, d)
    return torch.einsum("zk,axyk->axyz", bz, d).float()


def elastic_resample_pair(src: torch.Tensor, gt: torch.Tensor, grid: torch.Tensor) -> Pair:
    """Apply a control-point displacement grid: linear image, nearest label,
    edge-clamped sampling (scipy's mode 'nearest')."""
    shape = src.shape[1:]
    grid = torch.as_tensor(grid, dtype=torch.float32).to(src.device)
    coords = _identity_grid(shape, src.device) + elastic_displacement(grid, shape)
    out_src = resample(src, coords, order=1, mode="nearest")
    out_gt = torch.round(resample(gt, coords, order=0, mode="nearest"))
    return out_src, out_gt


def elastic_grid(generator: torch.Generator, num_control_points: int = 7, max_displacement: float = 7.5,
                 locked_borders: int = 2) -> torch.Tensor:
    """tio.RandomElasticDeformation's draw: [3, n, n, n] displacements
    U(-max, max), zero on the ``locked_borders`` outer layers."""
    n = num_control_points
    grid = _uniform(generator, (3, n, n, n), -max_displacement, max_displacement)
    mask = np.zeros((n,), bool)
    mask[locked_borders:n - locked_borders] = True
    m = torch.from_numpy(mask[:, None, None] & mask[None, :, None] & mask[None, None, :]).to(grid.device)
    return torch.where(m[None], grid, torch.zeros((), device=grid.device))


def random_elastic_pair(generator: torch.Generator, src: torch.Tensor, gt: torch.Tensor,
                        num_control_points: int = 7, max_displacement: float = 7.5,
                        locked_borders: int = 2) -> Pair:
    """tio.RandomElasticDeformation defaults: 7^3 control points, maximum
    displacement 7.5, 2 locked border layers (transforms.RandomElasticDeformation)."""
    grid = elastic_grid(generator, num_control_points, max_displacement, locked_borders)
    return elastic_resample_pair(src, gt, grid)


def random_flip_pair(generator: torch.Generator, src: torch.Tensor, gt: torch.Tensor, axis: int = 0,
                     p: float = 0.5) -> Pair:
    """tio.RandomFlip(axes=(0,)): spatial axis 0 with probability 0.5, chosen
    on the device (no host read)."""
    do = _uniform(generator, (), 0.0, 1.0) < p

    def flip(v):
        return torch.where(do, v.flip(axis + 1), v)

    return flip(src), flip(gt)


def choose_affine(generator: torch.Generator, p_affine: float = 0.8) -> bool:
    """The OneOf's one draw: True for the affine branch (probability 0.8),
    False for the elastic one. The host reads it, so that only the chosen
    branch runs (JAX's ``lax.cond``)."""
    return bool(_uniform(generator, (), 0.0, 1.0) < p_affine)


def aug_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The augmentation's generator of ``epoch`` on ``device``, seeded with
    ``seed`` + epoch: the device backend's per-step loop
    (``device_prep.DevicePatchDataset``) and ``epoch_scan`` draw from it alike."""
    return torch.Generator(device=device).manual_seed(int(seed) + int(epoch))


def augment_pair(generator: torch.Generator, src: torch.Tensor, gt: torch.Tensor) -> Pair:
    """The full training augmentation in the reference's order
    (dataloader.py:69-93): BiasField -> ZNorm -> Noise -> Flip(0) ->
    OneOf{Affine 0.8, Elastic 0.2}, of which only the chosen branch runs.

    src / gt: [C, X, Y, Z] on the generator's device; returns f32 tensors of
    the same shapes, the label binary."""
    src = src.float() * polynomial_bias_field(generator, src.shape[1:])[None]
    src = znormalize(src)
    src = random_noise(generator, src)
    src, gt = random_flip_pair(generator, src, gt.float())
    if choose_affine(generator):
        return random_affine_pair(generator, src, gt)
    return random_elastic_pair(generator, src, gt)
