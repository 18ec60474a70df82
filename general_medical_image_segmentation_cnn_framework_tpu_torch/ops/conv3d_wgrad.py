"""Weight gradient of the k3 s1 SAME Conv3d / Conv2d, channels-last.

``conv3d_wgrad(x, g)`` gives dw[dz, dy, dx, ci, co] =
sum_{n,d,h,w} x[n, d+dz-1, h+dy-1, w+dx-1, ci] * g[n, d, h, w, co] in f32,
the conv's weight gradient for the cotangent ``g`` of its output. On a CUDA
tensor it runs the hand-written kernel ``csrc/conv3d_wgrad.cu`` (which
replaces the Pallas kernel ``ops/pallas_tlayout.wgrad_tapcols_tlayout``),
adds one to ``conv3d_wgrad.launches`` and raises if the build or launch
fails. On a CPU tensor it runs ``conv3d_wgrad_reference``, the plain
PyTorch version, which is also the kernel's oracle in the tests and in
``chip_smoke.py``.

``conv2d_wgrad(x, g)`` is the same for the 2-D conv on NHWC tensors:
dw [3, 3, Cin, Cout], the kernel with one depth tap (KD = 1) on x and g
taken as NDHWC with D = 1, with its own count ``conv2d_wgrad.launches``
and its plain version ``conv2d_wgrad_reference``. The JAX package computes
this product in XLA (``ops/pallas_tlayout._wgrad2d_tlayout``, in the VJP of
the Pallas kernel ``conv2d_plane_tlayout``).
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_BK = 64  # voxels per pipeline stage of the bf16 wgmma kernels; split chunks are multiples of it
_MIN_CHUNK = 512  # voxels a split sums at least


def output_tiles(rows: int, cout: int):
    """(blocks per split, blocks to aim for) of the weight gradient's bf16
    kernels for dw [rows, Cout], rows = taps x Cin. At Cout <= 64 (the slab
    variant and the stem) one block per two 64-row columns of (dz, dy) x
    Cin, aiming at two waves of one block per SM of an H100 (132 SMs); above
    (the gather variant) one per 128 rows x 128 channels, aiming at four
    (measured on the H100: the sums run 1-12% faster so than with either
    target for both)."""
    if cout <= 64:
        return -(-rows // (2 * 3 * 64)), 264
    return -(-rows // 128) * -(-cout // 128), 528


def _reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """For each tap (3^3 of a 3-D x, 3^2 of a 2-D one), the tap-shifted x
    (SAME zero padding) contracted with g over all voxels, in f32, or in
    f64 for f64 inputs."""
    nd = x.dim() - 2
    spatial, cin, cout = x.shape[1:-1], x.shape[-1], g.shape[-1]
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = F.pad(x.to(dt), (0, 0) + (1, 1) * nd)
    g2 = g.to(dt).reshape(-1, cout)
    taps = [
        xp[(slice(None), *(slice(o, o + s) for o, s in zip(offset, spatial)))].reshape(-1, cin).T @ g2
        for offset in itertools.product(range(3), repeat=nd)
    ]
    return torch.stack(taps).reshape(*(3,) * nd, cin, cout)


def conv3d_wgrad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version: for each of the 27 taps, the tap-shifted x (SAME zero
    padding) contracted with g over all voxels. x [N,D,H,W,Cin],
    g [N,D,H,W,Cout] -> [3,3,3,Cin,Cout], computed and returned in f32, or
    in f64 for f64 inputs: an oracle whose own rounding is negligible next
    to a kernel's f32 accumulation over millions of voxels."""
    return _reference(x, g)


def conv2d_wgrad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of ``conv2d_wgrad``: the 9 taps of x [N,H,W,Cin]
    contracted with g [N,H,W,Cout] -> [3,3,Cin,Cout], in f32 (f64 for f64
    inputs)."""
    return _reference(x, g)


def split_k(rows: int, cout: int, voxels: int):
    """(chunk, splits): how many voxels each split of the reduction sums and
    how many splits there are, so that output tiles x splits fill whole
    waves of the card (at most the target of ``output_tiles``). Depends on
    the shapes only, so a shape always sums in the same order."""
    tiles, target = output_tiles(rows, cout)
    splits = max(1, min(target // tiles, voxels // _MIN_CHUNK))
    per_split = -(-voxels // splits)
    chunk = -(-per_split // _BK) * _BK
    return chunk, -(-voxels // chunk)


def _check(x: torch.Tensor, g: torch.Tensor, nd: int) -> None:
    name = f"conv{nd}d_wgrad"
    if (x.dtype not in _DTYPES and not (x.dtype == torch.float64 and x.device.type == "cpu")) or g.dtype != x.dtype:
        raise TypeError(f"{name}: x and g must both be float32 or bfloat16 (or float64 on the CPU), "
                        f"got {x.dtype}, {g.dtype}")
    if (x.dim() != nd + 2 or g.dim() != nd + 2 or x.numel() == 0 or g.numel() == 0
            or x.shape[:-1] != g.shape[:-1]):
        dims = "N,D,H,W" if nd == 3 else "N,H,W"
        raise ValueError(
            f"{name}: x [{dims},Cin] and g [{dims},Cout] must share {dims}, got "
            f"{tuple(x.shape)}, {tuple(g.shape)}"
        )
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError(f"{name}: x and g must be contiguous")
    if x.device != g.device:
        raise ValueError(f"{name}: x and g must share a device, got {x.device}, {g.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


@functools.cache
def _kernel():
    fn = _build.load("conv3d_wgrad").conv3d_wgrad_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The kernel on x [N,D,H,W,Cin] (KD = 3) or [N,H,W,Cin] (KD = 1, launched
    as D = 1) -> dw f32 [3,..,3,Cin,Cout] of x's spatial rank."""
    nd = x.dim() - 2
    n, *spatial, cin = x.shape
    d, h, w = spatial if nd == 3 else (1, *spatial)
    cout = g.shape[-1]
    kd = 3 if nd == 3 else 1
    chunk, splits = split_k(kd * 9 * cin, cout, n * d * h * w)
    dw = torch.empty((3,) * nd + (cin, cout), dtype=torch.float32, device=x.device)
    # the split partials, summed in split order by the kernel's second pass
    part = torch.empty((splits, kd * 9 * cin, cout), dtype=torch.float32, device=x.device) if splits > 1 else dw
    err = _kernel()(
        x.data_ptr(), g.data_ptr(), dw.data_ptr(), part.data_ptr(),
        n, d, h, w, cin, cout, kd, chunk, splits, int(x.dtype == torch.bfloat16),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv{nd}d_wgrad: CUDA launch failed with cudaError {err}")
    return dw


def conv3d_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw f32 [3,3,3,Cin,Cout] of the k3 s1 SAME conv3d of x [N,D,H,W,Cin]
    for the output cotangent g [N,D,H,W,Cout]; x and g in one dtype,
    float32 or bfloat16 (or float64 on the CPU: f64 dw)."""
    _check(x, g, 3)
    if x.device.type == "cpu":
        return conv3d_wgrad_reference(x, g)
    dw = _launch(x, g)
    _build.count_launch(conv3d_wgrad)
    return dw


conv3d_wgrad.launches = 0


def conv2d_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw f32 [3,3,Cin,Cout] of the k3 s1 SAME conv2d of x [N,H,W,Cin] for
    the output cotangent g [N,H,W,Cout]; x and g in one dtype, float32 or
    bfloat16. A CUDA tensor runs the kernel with one depth tap and adds one
    to ``conv2d_wgrad.launches``; a CPU tensor runs the plain version."""
    _check(x, g, 2)
    if x.device.type == "cpu":
        return conv2d_wgrad_reference(x, g)
    dw = _launch(x, g)
    _build.count_launch(conv2d_wgrad)
    return dw


conv2d_wgrad.launches = 0
