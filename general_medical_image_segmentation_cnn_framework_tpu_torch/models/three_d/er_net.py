"""ER-Net: a reverse-attention residual encoder and a selective-fusion
decoder, channels-last, as the JAX package's ``models/three_d/er_net.py``:
``ResEncoder`` blocks (conv-BN-ReLU x2 plus a 1x1 residual), reverse-
attention gates ``(1 - sigmoid(up(conv1x1(deeper)))) * enc + enc`` and the
SK-style ``SFConv`` fusion (a softmax over the two branches' attention
vectors) in each decoder level.

Built from bare ``TorchConv`` + BatchNorm + ReLU, not ``ConvBlock``: its
14 k3 s1 p1 convs run the hand-written kernels in train mode and the eval
conv (``conv3d_bn_relu`` with relu=False, BatchNorm after it) in eval.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.blocks import Dense, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io, max_pool
from ...nn.norm import BatchNorm


def _bn_relu(bn: BatchNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.relu(bn(x).to(dtype))


class ResEncoder(nn.Module):
    """relu(relu(BN(conv3(relu(BN(conv3(x)))))) + conv1x1(x))."""

    def __init__(self, cin, cout, dtype, init_type, gen):
        super().__init__()
        self.dtype = dtype
        convs, bns = ScopeNames(), ScopeNames()
        self.residual = convs(TorchConv(cin, cout, dtype, init_type, gen, kernel_size=1))
        self.conv1 = convs(TorchConv(cin, cout, dtype, init_type, gen, kernel_size=3, padding=1))
        self.bn1 = bns(BatchNorm(cout))
        self.conv2 = convs(TorchConv(cout, cout, dtype, init_type, gen, kernel_size=3, padding=1))
        self.bn2 = bns(BatchNorm(cout))

    def forward(self, x):
        residual = self.residual(x)
        out = _bn_relu(self.bn1, self.conv1(x), self.dtype)
        out = _bn_relu(self.bn2, self.conv2(out), self.dtype)
        return torch.relu(out + residual)


class SFConv(nn.Module):
    """Selective fusion of two branches: attention vectors from the global
    mean of their sum, a softmax over the branches per channel."""

    def __init__(self, features, dtype, gen, M: int = 2, r: int = 4, L: int = 32):
        super().__init__()
        d = max(features // r, L)
        dense = ScopeNames()
        self.fc = dense(Dense(features, d, dtype, gen))
        self.fcs = nn.ModuleList(dense(Dense(d, features, dtype, gen)) for _ in range(M))

    def forward(self, x1, x2):
        feas = torch.stack([x1, x2], dim=1)  # [B, M, D, H, W, C]
        fea_z = self.fc(feas.sum(dim=1).mean(dim=(1, 2, 3)))
        att = torch.softmax(torch.stack([fc(fea_z) for fc in self.fcs], dim=1), dim=1)  # [B, M, C]
        return (feas * att[:, :, None, None, None, :]).sum(dim=1)


class SFDecoder(nn.Module):
    """SFConv -> BN -> ReLU, then a ResEncoder-shaped block (the reference's ResDecoder)."""

    def __init__(self, features, dtype, init_type, gen):
        super().__init__()
        self.dtype = dtype
        convs, bns = ScopeNames(), ScopeNames()
        self.sf = SFConv(features, dtype, gen)
        self.sf.scope = "SFConv_0"
        self.bn0 = bns(BatchNorm(features))
        self.residual = convs(TorchConv(features, features, dtype, init_type, gen, kernel_size=1))
        self.conv1 = convs(TorchConv(features, features, dtype, init_type, gen, kernel_size=3, padding=1))
        self.bn1 = bns(BatchNorm(features))
        self.conv2 = convs(TorchConv(features, features, dtype, init_type, gen, kernel_size=3, padding=1))
        self.bn2 = bns(BatchNorm(features))

    def forward(self, x1, x2):
        out = _bn_relu(self.bn0, self.sf(x1, x2), self.dtype)
        residual = self.residual(out)
        y = _bn_relu(self.bn1, self.conv1(out), self.dtype)
        y = _bn_relu(self.bn2, self.conv2(y), self.dtype)
        return torch.relu(y + residual)


class ReverseAttentionEncoder(nn.Module):
    """The encoder ER-Net and RE-Net share: ResEncoders at 32, 64, 128 and
    256 channels with 2x max-pool downs, and the three reverse-attention
    gates. Not a scope of its own in the JAX models: its children are
    named in the enclosing network's scope, by the namers it is given."""

    def __init__(self, in_channels, dtype, init_type, gen, encoders, convs, ups):
        super().__init__()
        self.encs = nn.ModuleList(
            encoders(ResEncoder(ci, co, dtype, init_type, gen))
            for ci, co in ((in_channels, 32), (32, 64), (64, 128), (128, 256))
        )
        self.gate_convs = nn.ModuleList()
        self.gate_ups = nn.ModuleList()
        for c in (64, 128, 256):
            self.gate_convs.append(convs(TorchConv(c, 1, dtype, init_type, gen, kernel_size=1)))
            self.gate_ups.append(ups(TorchConvTranspose(1, 1, dtype, init_type, gen)))

    def forward(self, x):
        """(bridge, x1, x2, x3): the bottom, and the gated enc3, enc2, enc1."""
        enc1 = self.encs[0](x)
        enc2 = self.encs[1](max_pool(enc1))
        enc3 = self.encs[2](max_pool(enc2))
        bridge = self.encs[3](max_pool(enc3))

        def gate(i, deeper, enc):
            g = self.gate_ups[i](self.gate_convs[i](deeper))
            return (1.0 - torch.sigmoid(g)) * enc + enc

        return bridge, gate(2, bridge, enc3), gate(1, enc3, enc2), gate(0, enc2, enc1)


class ERNet(nn.Module):
    def __init__(
        self, classes: int = 2, channels: int = 1, dtype: torch.dtype = torch.float32,
        init_type: str = "none", seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        convs, ups = ScopeNames(), ScopeNames()
        self.encoder = ReverseAttentionEncoder(channels, dtype, init_type, gen, ScopeNames(), convs, ups)
        self.deconvs = nn.ModuleList(
            ups(TorchConvTranspose(ci, co, dtype, init_type, gen)) for ci, co in ((256, 128), (128, 64), (64, 32))
        )
        decoders = ScopeNames()
        self.decoders = nn.ModuleList(decoders(SFDecoder(c, dtype, init_type, gen)) for c in (128, 64, 32))
        self.head = convs(TorchConv(32, classes, dtype, init_type, gen, kernel_size=1))

    @classmethod
    def from_config(cls, config) -> "ERNet":
        """``ERNet(classes=out_classes, channels=in_classes)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(config.out_classes, config.in_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "ERNet":
        """A model of the widths of the JAX ERNet's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        cin = flax_conv_io(params, "ResEncoder_0", "TorchConv_1")[0]
        return cls(flax_conv_io(params, "TorchConv_3")[1], cin, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, *gated = self.encoder(x)
        for deconv, decoder, skip in zip(self.deconvs, self.decoders, gated):
            out = decoder(deconv(out), skip)
        return self.head(out).float()
