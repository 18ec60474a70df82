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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = (xf.square().mean(dim=axes) - mean.square()).clamp_min(0.0)
            n = xf.numel() // xf.shape[-1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)
