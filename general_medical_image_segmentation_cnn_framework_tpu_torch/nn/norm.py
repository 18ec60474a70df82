"""BatchNorm over channels-last tensors with the JAX package's numerics.

Eval uses the running statistics, and an eval ConvBlock does not call this
module at all: it folds the four tensors into its conv
(``ops.conv3d_bn_relu.fold_batchnorm``). Train mode follows
``nn/norm.py`` of the JAX package: batch statistics in f32 with
var = E[x^2] - E[x]^2 clamped at 0, and the running variance updated with
the unbiased estimate, momentum 0.1 on the new value.
"""

from __future__ import annotations

import torch
from torch import nn


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
        """(mean, var) over every axis but the last, f32, var = E[x^2] - E[x]^2 >= 0."""
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
        xf = x.float()
        mean, var = self.batch_stats(xf)
        return self._affine(xf, mean, var).to(x.dtype), mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._affine(x.float(), self.running_mean, self.running_var).to(x.dtype)
        y, mean, var = self.train_forward(x)
        self.update_running(mean, var, x.numel() // x.shape[-1])
        return y
