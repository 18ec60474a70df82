"""BatchNorm, InstanceNorm and LayerNorm over channels-last tensors with the JAX package's numerics.

Eval uses the running statistics, and an eval ConvBlock does not call this
module at all: it folds the four tensors into its conv
(``ops.conv3d_bn_relu.fold_batchnorm``). Train mode follows
``nn/norm.py`` of the JAX package: batch statistics in f32 with
var = E[x^2] - E[x]^2 clamped at 0, and the running variance updated with
the unbiased estimate, momentum 0.1 on the new value. Statistics are
computed in f32, or in f64 for an f64 input (a model built with
``dtype=torch.float64`` on the CPU, which the tests hold to the JAX
package in f64).
"""

from __future__ import annotations

import torch
from torch import nn


def _stat(x: torch.Tensor) -> torch.Tensor:
    """x in the dtype its statistics are computed in: f32, or f64 for f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis. Parameters ``weight`` (the JAX
    ``scale``) and ``bias``; buffers ``running_mean`` and ``running_var``."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @staticmethod
    def batch_stats(xf: torch.Tensor):
        """(mean, var) over every axis but the last, var = E[x^2] - E[x]^2 >= 0."""
        axes = tuple(range(xf.dim() - 1))
        mean = xf.mean(dim=axes)
        return mean, (xf.square().mean(dim=axes) - mean.square()).clamp_min(0.0)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """Running statistics from one batch's (mean, var) over ``n`` values
        per channel: momentum on the new value, the unbiased variance."""
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean)
        self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))

    def _affine(self, xf: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        return (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias

    def train_forward(self, x: torch.Tensor):
        """(y, mean, var) of train mode without touching the running
        statistics: a recomputed forward (``ConvBlock``'s remat) must not
        move them a second time."""
        xf = _stat(x)
        mean, var = self.batch_stats(xf)
        return self._affine(xf, mean, var).to(x.dtype), mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._affine(_stat(x), self.running_mean, self.running_var).to(x.dtype)
        y, mean, var = self.train_forward(x)
        self.update_running(mean, var, x.numel() // x.shape[-1])
        return y


class InstanceNorm(nn.Module):
    """InstanceNorm over channels-last tensors (torch ``InstanceNorm3d``
    defaults, as the JAX package's): per sample and channel, statistics over
    the spatial axes in f32, var the mean squared deviation, eps 1e-5, no
    running statistics; ``affine`` adds ``weight`` (the JAX ``scale``) and
    ``bias``. The result is cast to ``dtype`` (default: x's)."""

    def __init__(self, features: int = 0, eps: float = 1e-5, affine: bool = False, dtype=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.dim() - 1))
        xf = _stat(x)
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y.to(self.dtype or x.dtype)


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm`` over the last axis (the transformers' norm):
    statistics in f32 (f64 for an f64 input) with var = E[x^2] - E[x]^2
    clamped at 0 (Flax's ``use_fast_variance``), eps 1e-6 (Flax's default,
    not torch's 1e-5), y = (x - mean) * (rsqrt(var + eps) * weight) + bias
    in that precision, cast to ``dtype`` (default: x's). Parameters
    ``weight`` (the JAX ``scale``) and ``bias``."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = _stat(x)
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype or x.dtype)
