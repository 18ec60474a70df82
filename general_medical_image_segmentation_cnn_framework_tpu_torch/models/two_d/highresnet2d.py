"""HighRes2DNet: the port's rank-generic HighResNet on NHWC slices, as the
JAX package's ``models/two_d/highresnet2d.py`` (a subclass with
``dimensions = 2``). Its stem and first stage's k3 s1 p1 convs run the
KD = 1 instances of the hand-written kernels, 7 calls a forward."""

from __future__ import annotations

from ..three_d.highresnet import HighResNet


class HighRes2DNet(HighResNet):
    def __init__(self, in_channels: int = 1, out_channels: int = 2, **kwargs):
        kwargs.setdefault("dimensions", 2)
        super().__init__(in_channels, out_channels, **kwargs)
