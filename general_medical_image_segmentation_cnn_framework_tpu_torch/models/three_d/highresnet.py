"""HighResNet (Li et al. 2017), channels-last, as the JAX package's
``models/three_d/highresnet.py``: a post-activation conv block to
2**initial_out_channels_power channels, then ``dilations`` stages of
``DilationBlock`` (dilation 2**i, channels doubling from the second stage
on), an optional dropout head, and a 1x1 post-activation classifier
without activation. No downsampling: the volume keeps its size.

The stem and the first stage's convs (k3, dilation 1, zero padding: the
k3 s1 p1 conv, 7 a forward) run the hand-written kernels; the dilated
stages are ``F.conv3d`` (XLA's conv in the JAX package).
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import Dropout, ScopeNames, flax_conv_io
from ...nn.residual import ConvolutionalBlock, DilationBlock


class HighResNet(nn.Module):
    def __init__(
        self, in_channels: int = 1, out_channels: int = 2, dimensions: int = 3,
        initial_out_channels_power: int = 4, layers_per_residual_block: int = 2,
        residual_blocks_per_dilation: int = 3, dilations: int = 3, batch_norm: bool = True,
        instance_norm: bool = False, residual: bool = True, padding_mode: str = "constant",
        add_dropout_layer: bool = False, dtype: torch.dtype = torch.float32, init_type: str = "none", seed: int = 0,
    ):
        super().__init__()
        self.dtype, self.dimensions = dtype, dimensions
        gen = torch.Generator().manual_seed(seed)
        kw = dict(batch_norm=batch_norm, instance_norm=instance_norm, padding_mode=padding_mode,
                  init_type=init_type, dtype=dtype, generator=gen, ndim=dimensions)
        convs, stages = ScopeNames(), ScopeNames()
        initial = 2**initial_out_channels_power
        self.stem = convs(ConvolutionalBlock(in_channels, initial, 1, preactivation=False, **kw))
        self.stages = nn.ModuleList()
        cin = cout = initial
        for i in range(dilations):
            self.stages.append(stages(DilationBlock(
                cin, cout, 2**i, layers_per_residual_block, residual_blocks_per_dilation, residual=residual, **kw,
            )))
            cin, cout = cout, 2 * cout
        self.dropout_head = None
        if add_dropout_layer:
            self.dropout_head = convs(ConvolutionalBlock(
                cin, 80, 1, batch_norm, instance_norm, preactivation=False, kernel_size=1, init_type=init_type,
                dtype=dtype, generator=gen, ndim=dimensions,
            ))
            self.dropout = Dropout(0.5, generator=gen)
            cin = 80
        self.classifier = convs(ConvolutionalBlock(
            cin, out_channels, 1, preactivation=False, kernel_size=1, activation=False, **kw,
        ))

    @classmethod
    def from_config(cls, config) -> "HighResNet":
        """``HighRes3DNet(in_classes, out_classes)`` with the dataclass
        defaults, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.in_classes, config.out_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "HighResNet":
        """A model of the widths of the JAX HighResNet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        return cls(flax_conv_io(params, "ConvolutionalBlock_0", "TorchConv_0")[0],
                   flax_conv_io(params, "ConvolutionalBlock_1", "TorchConv_0")[1], **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() - 2 != self.dimensions:
            raise ValueError(f"HighResNet: a {self.dimensions}-D network, got x of shape {tuple(x.shape)}")
        y = self.stem(x)
        for stage in self.stages:
            y = stage(y)
        if self.dropout_head is not None:
            y = self.dropout(self.dropout_head(y))
        return self.classifier(y).float()
