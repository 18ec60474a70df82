"""3-D FCN-8s (a VGG-style fully convolutional net), channels-last, as the
JAX package's ``models/three_d/fcn3d.py``: a first conv padded by 60, five
conv stages (2, 2, 3, 3, 3 convs with ReLU; the second stage's first conv
padded by 15) each ending in a ceil-mode 2x max pool, the k7 and 1x1 "fc"
convs to 512 with Dropout(0.5), a 1x1 score conv, and the FCN-8s fusion:
bilinear-initialised VALID transposed convs (k4 s2, k4 s2, k16 s8) over
the scores summed with the 1x1 scores of pool4 (scaled by 0.01, cropped at
5) and pool3 (scaled by 1e-4, cropped at 9), the output cropped at 31 to
the input's size. Every conv is initialised N(0, 0.02) with a zero bias
(``init_type`` normal, whatever the config says: the JAX model takes none).

The JAX package computes ``_BilinearDeconv`` through its phased
transposed conv (a TPU route); here it is the function that route
computes, ``F.conv_transpose3d``. The 11 k3 s1 p1 convs (the p60 and p15
convs excepted) run the hand-written kernels; the padded convs and the
k7 head are ``F.conv3d``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...nn.blocks import Dropout, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io, max_pool_ceil

# (Cin, Cout, kernel, padding) of TorchConv_0 .. TorchConv_12, the five stages; a stage's pool follows
# the convs at the indices of STAGE_ENDS
_FEATURES = [(8, 3, 60), (8, 3, 1), (16, 3, 15), (16, 3, 1), (32, 3, 1), (32, 3, 1), (32, 3, 1),
             (64, 3, 1), (64, 3, 1), (64, 3, 1), (64, 3, 1), (64, 3, 1), (64, 3, 1)]
STAGE_ENDS = (1, 3, 6, 9, 12)


def bilinear_kernel(shape) -> torch.Tensor:
    """The JAX package's ``bilinear_kernel_init`` (and FCN32s's
    ``_bilinear_kernel_init_2d``): a [k, k, k, Cin, Cout] (or [k, k, Cin,
    Cout]) kernel with the separable bilinear upsampling filter on each
    matching (c, c) channel pair, zero elsewhere."""
    k, cin, cout = shape[0], shape[-2], shape[-1]
    factor = (k + 1) // 2
    center = factor - 1 if k % 2 == 1 else factor - 0.5
    filt = 1.0
    for og in np.ogrid[(slice(k),) * (len(shape) - 2)]:
        filt = filt * (1 - abs(og - center) / factor)
    w = np.zeros(shape, dtype=np.float32)
    for c in range(min(cin, cout)):
        w[..., c, c] = filt
    return torch.from_numpy(w)


class _BilinearDeconv(TorchConvTranspose):
    """A bias-free VALID transposed conv, output (in - 1) * stride + kernel,
    its ``weight`` (the JAX ``kernel``, directly in the module's scope)
    initialised by ``bilinear_kernel``."""

    def __init__(self, cin, cout, kernel_size, stride, dtype, gen):
        super().__init__(cin, cout, dtype, "none", gen, kernel_size=kernel_size, stride=stride, use_bias=False)
        with torch.no_grad():
            self.weight.copy_(bilinear_kernel(tuple(self.weight.shape)))


class FCN3D(nn.Module):
    def __init__(self, in_channels: int = 1, n_class: int = 1, dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        names = ScopeNames()

        def conv(cin, cout, k=3, p=1):
            return names(TorchConv(cin, cout, dtype, "normal", gen, kernel_size=k, padding=p))

        self.features = nn.ModuleList()
        cin = in_channels
        for cout, k, p in _FEATURES:
            self.features.append(conv(cin, cout, k, p))
            cin = cout
        self.fc6 = conv(64, 512, 7, 0)
        self.fc7 = conv(512, 512, 1, 0)
        self.drop6, self.drop7 = Dropout(0.5, generator=gen), Dropout(0.5, generator=gen)
        self.score = conv(512, n_class, 1, 0)
        self.score_pool4 = conv(64, n_class, 1, 0)
        self.score_pool3 = conv(32, n_class, 1, 0)
        self.upscore2 = names(_BilinearDeconv(n_class, n_class, 4, 2, dtype, gen))
        self.upscore_pool4 = names(_BilinearDeconv(n_class, n_class, 4, 2, dtype, gen))
        self.upscore8 = names(_BilinearDeconv(n_class, n_class, 16, 8, dtype, gen))

    @classmethod
    def from_config(cls, config) -> "FCN3D":
        """``FCN3D(in_classes, out_classes)``, the JAX ``from_config`` (no
        ``init_type``: its convs are always N(0, 0.02))."""
        from ..registry import model_kwargs

        kw = model_kwargs(config)
        return cls(config.in_classes, config.out_classes, dtype=kw["dtype"], seed=kw["seed"])

    @classmethod
    def from_flax(cls, params, **kwargs) -> "FCN3D":
        """A model of the channels of the JAX FCN3D's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        return cls(flax_conv_io(params, "TorchConv_0")[0], flax_conv_io(params, "TorchConv_15")[1], **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, pools = x, []
        for i, conv in enumerate(self.features):
            h = torch.relu(conv(h))
            if i in STAGE_ENDS:
                h = max_pool_ceil(h)
                pools.append(h)
        pool3, pool4 = pools[2], pools[3]
        h = self.drop6(torch.relu(self.fc6(h)))
        h = self.drop7(torch.relu(self.fc7(h)))
        up = self.upscore2(self.score(h))
        s = up.shape[1:4]
        h = self.score_pool4(pool4 * 0.01)[:, 5:5 + s[0], 5:5 + s[1], 5:5 + s[2]]
        up = self.upscore_pool4(up + h)
        s = up.shape[1:4]
        h = self.score_pool3(pool3 * 0.0001)[:, 9:9 + s[0], 9:9 + s[1], 9:9 + s[2]]
        h = self.upscore8(up + h)
        d, hh, w = x.shape[1:4]
        return h[:, 31:31 + d, 31:31 + hh, 31:31 + w].float()
