"""Weight initialisation selected by ``config.init_type``, as in the JAX
package's ``nn/init.py``.

With gain 0.02, one of normal / xavier / xavier_uniform / kaiming /
orthogonal / none initialises every conv and transposed-conv kernel, and
every bias is zero. Kernels keep the JAX layout [..., Cin, Cout], so fans
are counted as there: fan_in = receptive field x Cin, fan_out = receptive
field x Cout. BatchNorm keeps weight 1 and bias 0. The draws come from an
explicit ``torch.Generator``; they follow the JAX initializers'
distributions, not their bits.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

_GAIN = 0.02
# std of a unit normal truncated to [-2, 2], by which Flax's truncated
# normal divides so that the truncated draw keeps the asked-for std
_TRUNC_STD = 0.87962566103423978

Initializer = Callable[[Sequence[int], torch.Generator], torch.Tensor]


def _fans(shape: Sequence[int]):
    receptive = math.prod(shape[:-2])
    return receptive * shape[-2], receptive * shape[-1]


def _normal(shape, gen, std):
    return torch.randn(tuple(shape), generator=gen) * std


def _uniform(shape, gen, bound):
    return (torch.rand(tuple(shape), generator=gen) * 2.0 - 1.0) * bound


def _orthogonal(shape, gen, scale):
    """Flax ``orthogonal``: the [prod(shape[:-1]), shape[-1]] matrix has
    orthonormal columns (or rows, when it is wide), times ``scale``."""
    rows, cols = math.prod(shape[:-1]), shape[-1]
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return (scale * q).reshape(tuple(shape)).float()


def kernel_initializer(init_type: str) -> Initializer:
    """``(shape, generator) -> float32 tensor`` with the distribution of the
    JAX package's ``kernel_initializer(init_type)``."""
    if init_type == "normal":
        return lambda shape, gen: _normal(shape, gen, _GAIN)
    if init_type == "xavier":
        return lambda shape, gen: _normal(shape, gen, _GAIN * math.sqrt(2.0 / sum(_fans(shape))))
    if init_type == "xavier_uniform":
        return lambda shape, gen: _uniform(shape, gen, math.sqrt(6.0 / sum(_fans(shape))))
    if init_type == "kaiming":
        return lambda shape, gen: _normal(shape, gen, math.sqrt(2.0 / _fans(shape)[0]))
    if init_type == "orthogonal":
        return lambda shape, gen: _orthogonal(shape, gen, _GAIN)
    if init_type == "none":
        return lambda shape, gen: _uniform(shape, gen, math.sqrt(1.0 / _fans(shape)[0]))
    raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


def bias_initializer(init_type: str) -> Initializer:
    """Biases are zero for every init type."""
    del init_type
    return lambda shape, gen: torch.zeros(tuple(shape))


def truncated_normal(shape: Sequence[int], gen: torch.Generator, std: float) -> torch.Tensor:
    """Flax's ``truncated_normal(stddev=std)``: a unit normal truncated at
    two std, scaled so that the truncated draw has std ``std``."""
    t = torch.empty(tuple(shape))
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * (std / _TRUNC_STD)


def lecun_normal(shape: Sequence[int], gen: torch.Generator) -> torch.Tensor:
    """Flax's default kernel init (the UNet3D head is a plain ``nn.Conv``, not
    ``init_type``): a normal truncated at two std, std sqrt(1 / fan_in)."""
    return truncated_normal(shape, gen, math.sqrt(1.0 / _fans(shape)[0]))
