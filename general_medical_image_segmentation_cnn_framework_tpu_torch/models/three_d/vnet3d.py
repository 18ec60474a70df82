"""V-Net (Milletari et al. 2016), channels-last, as the JAX package's
``models/three_d/vnet3d.py``: k5 p2 convs with BatchNorm and ELU (or
per-channel PReLU), the input transition adding the channel-repeated input
as a residual, k2 s2 strided down-convs, k2 s2 transposed up-convs with
skip concatenation (the skip through a whole-channel Dropout3d(0.5) in
train mode), residual adds in every transition, and a k5 + k1 output
transition. V-Net has no k3 conv: its convs are ``F.conv3d`` (the JAX
package runs them through XLA, no Pallas kernel), its up-convs matmuls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.blocks import Dropout, PReLU, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io
from ...nn.norm import BatchNorm


class _Act(nn.Module):
    """ELU, or PReLU with one alpha per channel."""

    def __init__(self, elu: bool, nchan: int):
        super().__init__()
        self.elu = elu
        if not elu:
            self.prelu = PReLU(nchan)
            self.prelu.scope = "PReLU_0"

    def forward(self, x):
        return F.elu(x) if self.elu else self.prelu(x)


class _LUConv(nn.Module):
    """k5 p2 conv -> BatchNorm -> act, nchan -> nchan."""

    def __init__(self, nchan, elu, dtype, init_type, gen):
        super().__init__()
        self.conv = TorchConv(nchan, nchan, dtype, init_type, gen, kernel_size=5, padding=2)
        self.conv.scope = "TorchConv_0"
        self.bn = BatchNorm(nchan)
        self.bn.scope = "BatchNorm_0"
        self.act = _Act(elu, nchan)
        self.act.scope = "_Act_0"
        self.dtype = dtype

    def forward(self, x):
        return self.act(self.bn(self.conv(x)).to(self.dtype))


class _NConvs(nn.Module):
    def __init__(self, nchan, depth, elu, dtype, init_type, gen):
        super().__init__()
        names = ScopeNames()
        self.layers = nn.ModuleList(names(_LUConv(nchan, elu, dtype, init_type, gen)) for _ in range(depth))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class VNet(nn.Module):
    def __init__(
        self, elu: bool = True, in_channels: int = 1, classes: int = 2, dtype: torch.dtype = torch.float32,
        init_type: str = "none", seed: int = 0,
    ):
        super().__init__()
        self.dtype, self.in_channels = dtype, in_channels
        gen = torch.Generator().manual_seed(seed)
        convs, bns, acts, nconvs, ups = (ScopeNames() for _ in range(5))

        def bn(c):
            return bns(BatchNorm(c))

        def act(c):
            return acts(_Act(elu, c))

        # in creation order per class: the input transition, 4 downs, 4 ups, the output transition
        self.in_conv = convs(TorchConv(in_channels, 16, dtype, init_type, gen, kernel_size=5, padding=2))
        self.in_bn, self.in_act = bn(16), act(16)
        self.down_convs = nn.ModuleList(
            convs(TorchConv(c, 2 * c, dtype, init_type, gen, kernel_size=2, stride=2, padding=0))
            for c in (16, 32, 64, 128)
        )
        self.down_bns = nn.ModuleList()
        self.down_acts = nn.ModuleList()
        self.down_nconvs = nn.ModuleList()
        for c, depth in ((32, 1), (64, 2), (128, 3), (256, 2)):
            self.down_bns.append(bn(c))
            self.down_acts.append(act(c))
            self.down_nconvs.append(nconvs(_NConvs(c, depth, elu, dtype, init_type, gen)))
            self.down_acts.append(act(c))
        self.up_convs = nn.ModuleList()
        self.up_bns = nn.ModuleList()
        self.up_acts = nn.ModuleList()
        self.up_nconvs = nn.ModuleList()
        for cin, cout, depth in ((256, 256, 2), (256, 128, 2), (128, 64, 1), (64, 32, 1)):
            self.up_convs.append(ups(TorchConvTranspose(cin, cout // 2, dtype, init_type, gen)))
            self.up_bns.append(bn(cout // 2))
            self.up_acts.append(act(cout // 2))
            self.up_nconvs.append(nconvs(_NConvs(cout, depth, elu, dtype, init_type, gen)))
            self.up_acts.append(act(cout))
        self.skip_drop = Dropout(0.5, broadcast_dims=(1, 2, 3), generator=gen)
        self.out_conv = convs(TorchConv(32, classes, dtype, init_type, gen, kernel_size=5, padding=2))
        self.out_bn, self.out_act = bn(classes), act(classes)
        self.head = convs(TorchConv(classes, classes, dtype, init_type, gen, kernel_size=1, padding=0))

    @classmethod
    def from_config(cls, config) -> "VNet":
        """``VNet(elu=True, in_classes, out_classes)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(True, config.in_classes, config.out_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "VNet":
        """A model of the widths of the JAX VNet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        elu = "PReLU_0" not in params.get("_Act_0", {})
        return cls(elu, flax_conv_io(params, "TorchConv_0")[0], flax_conv_io(params, "TorchConv_6")[1], **kwargs)

    def _bn(self, bn, x):
        return bn(x).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._bn(self.in_bn, self.in_conv(x))
        out = self.in_act(out + x.repeat(1, 1, 1, 1, 16 // self.in_channels))
        skips = [out]
        for i in range(4):
            d = self.down_acts[2 * i](self._bn(self.down_bns[i], self.down_convs[i](out)))
            out = self.down_acts[2 * i + 1](self.down_nconvs[i](d) + d)
            skips.append(out)
        out = skips.pop()
        for i in range(4):
            u = self.up_acts[2 * i](self._bn(self.up_bns[i], self.up_convs[i](out)))
            xcat = torch.cat([u, self.skip_drop(skips.pop())], dim=-1)
            out = self.up_acts[2 * i + 1](self.up_nconvs[i](xcat) + xcat)
        out = self.out_act(self._bn(self.out_bn, self.out_conv(out)))
        return self.head(out).float()
