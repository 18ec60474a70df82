"""Host-side volume transforms with TorchIO-equivalent semantics.

The PyTorch port's own copy of the JAX package's ``data/transforms.py``
(same names and behaviour; numpy and scipy only).

The reference composes (when ``config.aug``):
RandomBiasField -> ZNormalization -> RandomNoise -> RandomFlip(axis 0) ->
OneOf{RandomAffine 0.8, RandomElasticDeformation 0.2}; otherwise just
ZNormalization (reference dataloader.py:69-112).

Intensity transforms (bias field, noise, z-norm) apply only to the source
image; spatial transforms apply to source (linear interpolation) and label
(nearest). All transforms consume an explicit ``np.random.Generator`` so the
pipeline is reproducible under ``config.seed``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from .io import Volume


class Subject:
    """A source/gt pair of co-registered volumes (cf. tio.Subject usage at
    reference dataloader.py:44-47)."""

    def __init__(self, source: Volume, gt: Optional[Volume] = None):
        self.source = source
        self.gt = gt

    @property
    def spatial_shape(self) -> Tuple[int, int, int]:
        return self.source.spatial_shape

    def copy(self) -> "Subject":
        return Subject(self.source.copy(), self.gt.copy() if self.gt is not None else None)


class Transform:
    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        for t in self.transforms:
            subject = t(subject, rng)
        return subject


class OneOf(Transform):
    """Weighted random choice between transforms (tio.OneOf)."""

    def __init__(self, weighted: Dict[Transform, float]):
        self.transforms = list(weighted.keys())
        w = np.asarray(list(weighted.values()), dtype=np.float64)
        self.probs = w / w.sum()

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        idx = rng.choice(len(self.transforms), p=self.probs)
        return self.transforms[idx](subject, rng)


class ZNormalization(Transform):
    """(x - mean) / std over the whole image; source only (tio.ZNormalization
    with default masking, reference dataloader.py:84,100,109)."""

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        data = subject.source.data.astype(np.float32)
        mean = data.mean()
        std = data.std()
        if std == 0:
            std = 1.0
        subject.source.data = (data - mean) / std
        return subject

    # Also usable without a Subject/rng for the predict path:
    def normalize_array(self, data: np.ndarray) -> np.ndarray:
        data = data.astype(np.float32)
        std = data.std()
        return (data - data.mean()) / (std if std != 0 else 1.0)


class RandomNoise(Transform):
    """Additive Gaussian noise: mean 0, std ~ U(0, 0.25) (tio defaults)."""

    def __init__(self, mean: float = 0.0, std: Tuple[float, float] = (0.0, 0.25)):
        self.mean = mean
        self.std = std

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        std = rng.uniform(*self.std)
        # float32 draws: half the bytes and ~2x the rate of the float64
        # default (the noise is added to float32 voxels anyway)
        noise = rng.standard_normal(
            size=subject.source.data.shape, dtype=np.float32
        )
        subject.source.data = (
            subject.source.data.astype(np.float32)
            + np.float32(std) * noise
            + np.float32(self.mean)
        )
        return subject


class RandomFlip(Transform):
    """Flip along the given spatial axes with probability 0.5 each
    (tio.RandomFlip(axes=(0,)), reference dataloader.py:87)."""

    def __init__(self, axes: Sequence[int] = (0,), flip_probability: float = 0.5):
        self.axes = tuple(axes)
        self.p = flip_probability

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        for axis in self.axes:
            if rng.uniform() < self.p:
                subject.source.data = np.flip(subject.source.data, axis=axis + 1).copy()
                if subject.gt is not None:
                    subject.gt.data = np.flip(subject.gt.data, axis=axis + 1).copy()
        return subject


class RandomBiasField(Transform):
    """Multiplicative polynomial bias field, exp(poly(order 3)) with
    coefficients ~ U(-0.5, 0.5) (tio.RandomBiasField defaults)."""

    def __init__(self, coefficients: float = 0.5, order: int = 3):
        self.coefficients = coefficients
        self.order = order

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        shape = subject.source.spatial_shape
        # Each monomial x^a y^b z^c is separable, so the whole polynomial is
        # one [order+1]^3 coefficient tensor contracted with three per-axis
        # power tables — O(voxels) instead of 20 full-volume products
        # (measured 1.25 s -> 60 ms per 160^3 volume). Coefficient draw
        # order matches the reference's nested loop.
        ranges = [np.linspace(-1.0, 1.0, s, dtype=np.float32) for s in shape]
        o = self.order + 1
        coeffs = np.zeros((o, o, o), dtype=np.float32)
        for xo in range(o):
            for yo in range(o - xo):
                for zo in range(o - xo - yo):
                    coeffs[xo, yo, zo] = rng.uniform(
                        -self.coefficients, self.coefficients
                    )
        powers = [
            np.stack([r**e for e in range(o)]) for r in ranges
        ]  # 3 x [o, s_axis]
        field = np.einsum(
            "abc,ax,by,cz->xyz", coeffs, *powers, optimize=True
        )
        np.exp(field, out=field)
        subject.source.data = subject.source.data.astype(np.float32) * field[None]
        return subject


def _affine_matrix(
    scales: np.ndarray, degrees: np.ndarray, translation: np.ndarray, center: np.ndarray
) -> np.ndarray:
    """Build a 4x4 voxel-space affine: rotate (deg, xyz order) + scale about
    ``center``, then translate."""
    rx, ry, rz = np.deg2rad(degrees)
    cx, cy, cz = np.cos([rx, ry, rz])
    sx, sy, sz = np.sin([rx, ry, rz])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx
    S = np.diag(scales)
    M = np.eye(4)
    M[:3, :3] = R @ S
    M[:3, 3] = center - M[:3, :3] @ center + translation
    return M


class RandomAffine(Transform):
    """Random scale/rotate/translate (tio.RandomAffine defaults:
    scales 0.1 -> U(0.9, 1.1), degrees 10, translation 0; linear interp for
    images, nearest for labels, reference dataloader.py:89)."""

    def __init__(
        self,
        scales: float = 0.1,
        degrees: float = 10.0,
        translation: float = 0.0,
    ):
        self.scales = scales
        self.degrees = degrees
        self.translation = translation

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        scales = rng.uniform(1 - self.scales, 1 + self.scales, size=3)
        degrees = rng.uniform(-self.degrees, self.degrees, size=3)
        translation = rng.uniform(-self.translation, self.translation, size=3)
        center = (np.asarray(subject.spatial_shape, dtype=np.float64) - 1) / 2.0
        M = _affine_matrix(scales, degrees, translation, center)
        # ndimage.affine_transform maps output coords -> input coords: use inverse
        Minv = np.linalg.inv(M)

        def apply(vol: Volume, order: int, cval: float) -> None:
            out = np.empty_like(vol.data, dtype=np.float32)
            for c in range(vol.data.shape[0]):
                out[c] = ndimage.affine_transform(
                    vol.data[c].astype(np.float32),
                    Minv[:3, :3],
                    offset=Minv[:3, 3],
                    order=order,
                    mode="constant",
                    cval=cval,
                )
            vol.data = out

        pad_val = float(subject.source.data.min())
        apply(subject.source, order=1, cval=pad_val)
        if subject.gt is not None:
            apply(subject.gt, order=0, cval=0.0)
            subject.gt.data = np.rint(subject.gt.data).astype(np.float32)
        return subject


def _cubic_bspline_kernel(t: np.ndarray) -> np.ndarray:
    """Centered uniform cubic B-spline basis B3(t) (support |t| < 2)."""
    at = np.abs(t)
    out = np.zeros_like(at)
    m1 = at < 1.0
    m2 = (at >= 1.0) & (at < 2.0)
    out[m1] = (4.0 - 6.0 * at[m1] ** 2 + 3.0 * at[m1] ** 3) / 6.0
    out[m2] = (2.0 - at[m2]) ** 3 / 6.0
    return out


def _bspline_axis_matrix(num_voxels: int, num_cp: int) -> np.ndarray:
    """[num_voxels, num_cp] cubic B-spline basis on the ITK transform-domain
    mesh: mesh_size = num_cp - 3 cells span the voxel-center extent
    (num_voxels - 1 for unit spacing), grid origin one cell before the
    domain, control point k at mesh coordinate k - 1."""
    mesh = num_cp - 3
    if mesh <= 0:
        raise ValueError(
            f"num_control_points must be >= 4 (got {num_cp}); the cubic "
            "B-spline mesh needs at least one cell (tio enforces the same)"
        )
    # singleton axis: the lone voxel center sits at extent 0, i.e. mesh
    # coordinate 1 regardless of cell size — avoid 0/0
    h = (num_voxels - 1) / mesh if num_voxels > 1 else 1.0  # control-cell size in voxels
    s = np.arange(num_voxels, dtype=np.float64) / h + 1.0  # mesh coords of voxel centers
    k = np.arange(num_cp, dtype=np.float64)
    return _cubic_bspline_kernel(s[:, None] - k[None, :])


class RandomElasticDeformation(Transform):
    """Coarse-grid elastic deformation (tio defaults: 7^3 control points,
    max_displacement 7.5, 2 locked border layers).

    The displacement field is the exact tensor-product cubic B-spline of the
    control-point coefficients on the ITK `BSplineTransformInitializer` mesh
    (mesh_size = n-3 cells over the voxel-center extent, grid origin one cell
    outside) — the same function SimpleITK's BSplineTransform evaluates, so
    this matches TorchIO's backend analytically rather than approximating it
    with an interpolating zoom. Only the RNG stream (numpy here, torch there)
    and the out-of-domain boundary rule (edge-clamp here; displacements at the
    edges are ~0 anyway with 2 locked layers) differ. Verified in
    tests/test_transforms.py against a direct per-voxel basis-sum oracle,
    partition-of-unity, and border-locking properties."""

    def __init__(self, num_control_points: int = 7, max_displacement: float = 7.5,
                 locked_borders: int = 2):
        self.num_control_points = num_control_points
        self.max_displacement = max_displacement
        self.locked_borders = locked_borders

    def displacement_field(self, grid: np.ndarray, shape) -> np.ndarray:
        """[3, n, n, n] control coefficients -> [3, *shape] voxel field."""
        bx, by, bz = (_bspline_axis_matrix(s, grid.shape[1 + i])
                      for i, s in enumerate(shape))
        d = np.einsum("xi,aijk->axjk", bx, grid)
        d = np.einsum("yj,axjk->axyk", by, d)
        return np.einsum("zk,axyk->axyz", bz, d)

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        shape = subject.spatial_shape
        n = self.num_control_points
        grid = rng.uniform(-self.max_displacement, self.max_displacement, size=(3, n, n, n))
        # tio zeroes `locked_borders` (default 2) outermost control layers so
        # the deformation vanishes well inside the volume edges
        for b in range(self.locked_borders):
            grid[:, [b, n - 1 - b], :, :] = 0
            grid[:, :, [b, n - 1 - b], :] = 0
            grid[:, :, :, [b, n - 1 - b]] = 0

        disp = self.displacement_field(grid, shape)
        coords = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
        sample = [coords[i] + disp[i].astype(np.float32) for i in range(3)]

        def apply(vol: Volume, order: int) -> None:
            out = np.empty_like(vol.data, dtype=np.float32)
            for c in range(vol.data.shape[0]):
                out[c] = ndimage.map_coordinates(
                    vol.data[c].astype(np.float32), sample, order=order, mode="nearest"
                )
            vol.data = out

        apply(subject.source, order=1)
        if subject.gt is not None:
            apply(subject.gt, order=0)
        return subject


class RescaleIntensity(Transform):
    """Linearly map source intensities to [out_min, out_max] using the
    (p_low, p_high) percentile window (tio.RescaleIntensity semantics)."""

    def __init__(self, out_min_max=(0.0, 1.0), percentiles=(0.0, 100.0)):
        self.out_min, self.out_max = out_min_max
        self.percentiles = percentiles

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        data = subject.source.data.astype(np.float32)
        lo, hi = np.percentile(data, self.percentiles)
        if hi == lo:
            subject.source.data = np.full_like(data, self.out_min)
            return subject
        data = np.clip(data, lo, hi)
        data = (data - lo) / (hi - lo) * (self.out_max - self.out_min) + self.out_min
        subject.source.data = data
        return subject


class CropOrPad(Transform):
    """Center crop/zero-pad every image to a target spatial shape
    (tio.CropOrPad semantics, padding split low/high like torchio)."""

    def __init__(self, target_shape: Sequence[int]):
        self.target = tuple(target_shape)

    def _fix(self, data: np.ndarray) -> np.ndarray:
        out = data
        for axis, target in enumerate(self.target, start=1):
            size = out.shape[axis]
            if size > target:
                lo = (size - target) // 2
                sl = [slice(None)] * out.ndim
                sl[axis] = slice(lo, lo + target)
                out = out[tuple(sl)]
            elif size < target:
                diff = target - size
                pads = [(0, 0)] * out.ndim
                pads[axis] = (diff // 2, diff - diff // 2)
                out = np.pad(out, pads)
        return out

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        subject.source.data = self._fix(subject.source.data)
        if subject.gt is not None:
            subject.gt.data = self._fix(subject.gt.data)
        return subject


class Resample(Transform):
    """Resample to a target isotropic spacing (tio.Resample semantics):
    linear interpolation for the source, nearest for the label; the affine
    is rescaled accordingly."""

    def __init__(self, target_spacing: float = 1.0):
        self.target = float(target_spacing)

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        spacing = subject.source.spacing
        zoom = [s / self.target for s in spacing]
        if all(abs(z - 1.0) < 1e-6 for z in zoom):
            return subject

        def apply(vol, order):
            out = np.stack(
                [ndimage.zoom(c.astype(np.float32), zoom, order=order) for c in vol.data]
            )
            vol.data = out
            scale = np.diag([1 / z for z in zoom] + [1.0])
            vol.affine = vol.affine @ scale

        apply(subject.source, order=1)
        if subject.gt is not None:
            apply(subject.gt, order=0)
        return subject


class ToCanonical(Transform):
    """Reorient data to RAS+ axis order using the affine
    (tio.ToCanonical semantics: axis flips/permutations only)."""

    def __call__(self, subject: Subject, rng: np.random.Generator) -> Subject:
        affine = subject.source.affine
        rot = affine[:3, :3]
        # nearest axis permutation: for each world axis pick dominant voxel axis
        perm = list(np.argmax(np.abs(rot), axis=1))
        if sorted(perm) != [0, 1, 2]:
            return subject  # oblique beyond permutation: leave unchanged
        flips = [rot[i, perm[i]] < 0 for i in range(3)]

        def apply(vol):
            data = np.transpose(vol.data, (0,) + tuple(p + 1 for p in perm))
            for axis, flip in enumerate(flips):
                if flip:
                    data = np.flip(data, axis=axis + 1)
            vol.data = np.ascontiguousarray(data)
            new_aff = np.eye(4)
            for i in range(3):
                sign = -1.0 if flips[i] else 1.0
                new_aff[:3, i] = sign * affine[:3, perm[i]]
                if flips[i]:
                    new_aff[:3, 3] += affine[:3, perm[i]] * (data.shape[i + 1] - 1)
            new_aff[:3, 3] += affine[:3, 3]
            vol.affine = new_aff

        apply(subject.source)
        if subject.gt is not None:
            apply(subject.gt)
        return subject


def build_transform(config, is_train: bool = True) -> Transform:
    """The reference's transform factory (dataloader.py:69-112): aug pipeline
    when config.aug and training, else plain ZNormalization."""
    if is_train and getattr(config, "aug", False):
        return Compose(
            [
                RandomBiasField(),
                ZNormalization(),
                RandomNoise(),
                RandomFlip(axes=(0,)),
                OneOf({RandomAffine(): 0.8, RandomElasticDeformation(): 0.2}),
            ]
        )
    return Compose([ZNormalization()])
