"""Gaussian frequency-domain low/high-pass filters.

The port's copy of the JAX package's ``utils/filters.py`` (capability parity
with the reference's ``utils/Filter.py``: scipy ``fourier_gaussian`` low and
high pass; unused by the entry scripts, but part of the library surface),
numpy/scipy on the host.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def gaussian_low_pass(image: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """Low-pass: fourier-domain gaussian smoothing."""
    freq = np.fft.fftn(image.astype(np.float32))
    filtered = ndimage.fourier_gaussian(freq, sigma=sigma)
    return np.real(np.fft.ifftn(filtered)).astype(np.float32)


def gaussian_high_pass(image: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """High-pass: original minus the gaussian low-pass component."""
    return image.astype(np.float32) - gaussian_low_pass(image, sigma)
