"""FFT band split of the IS network's extra inputs, as the JAX package's
``ops/fft.py``: one real FFT of the volume over its spatial axes, the
frequencies below (low) or above (high) ``limit`` kept along H and W (the
last two spatial axes), two inverse transforms. Only the spatial axes are
transformed, so batch elements never mix. The JAX package computes this
with ``jnp.fft`` (no Pallas kernel); here it is ``torch.fft`` (cuFFT on a
card), in f32, cast back to x's dtype.

Layout: channels-last [B, D, H, W, C].
"""

from __future__ import annotations

from typing import Tuple

import torch


def _freq_masks(h: int, w: int, limit: float, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) masks [h, w // 2 + 1] of the rfft's spectrum."""
    fw = torch.fft.rfftfreq(w, device=device).abs()  # the last axis (rfft)
    fh = torch.fft.fftfreq(h, device=device).abs()  # the one before it (full fft)
    low = (fh[:, None] < limit) & (fw[None, :] < limit)
    high = (fh[:, None] > limit) & (fw[None, :] > limit)
    return low, high


def band_split(x: torch.Tensor, limit: float = 0.04) -> Tuple[torch.Tensor, torch.Tensor]:
    """One FFT, two inverse transforms -> (low, high), each x's shape and
    dtype. x: [B, D, H, W, C]."""
    h, w = x.shape[2], x.shape[3]
    low_k, high_k = _freq_masks(h, w, limit, x.device)
    shape = x.shape[1:4]
    xf = torch.fft.rfftn(x.float(), dim=(1, 2, 3))
    kernel_shape = (1, 1, h, w // 2 + 1, 1)
    low = torch.fft.irfftn(xf * low_k.reshape(kernel_shape), s=shape, dim=(1, 2, 3))
    high = torch.fft.irfftn(xf * high_k.reshape(kernel_shape), s=shape, dim=(1, 2, 3))
    return low.to(x.dtype), high.to(x.dtype)


def low_pass(x: torch.Tensor, limit: float = 0.04) -> torch.Tensor:
    return band_split(x, limit)[0]


def high_pass(x: torch.Tensor, limit: float = 0.04) -> torch.Tensor:
    return band_split(x, limit)[1]
