"""FCN-32s (a VGG-16 fully convolutional net) on NHWC slices, as the JAX
package's ``models/two_d/fcn2d.py``: a first k3 conv padded by 100, five
stages of k3 p1 convs with ReLU (2, 2, 3, 3, 3 at 64, 128, 256, 512, 512)
each ending in a ceil-mode 2x max pool, the k7 VALID and 1x1 "fc" convs to
4096 with ReLU and Dropout(0.5), a 1x1 score conv, and the k64 s32 VALID
transposed conv ``upscore_kernel`` (a bare parameter of the model's own
scope, initialised bilinear), cropped at 19 to the input's size, in
float32. Every conv is kaiming-initialised with a zero bias, whatever the
config says (the JAX ``from_config`` passes no ``init_type``).

The JAX package computes the upscore through its phased transposed conv
(a TPU route); here it is the function that route computes,
``F.conv_transpose2d`` of the flipped kernel (the JAX convention, as
``nn.blocks.TorchConvTranspose``). The 12 k3 p1 convs after the first (p100)
run the KD = 1 hand-written kernels; the first conv and the k7 head are
``F.conv2d``, the 1x1 convs a matmul."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.blocks import Dropout, ScopeNames, TorchConv, flax_conv_io, max_pool_ceil
from ..three_d.fcn3d import bilinear_kernel

STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))  # (width, convs); a ceil pool ends each
UPSCORE = (64, 32, 19)  # the transposed conv's kernel and stride, the crop's offset


class FCN32s(nn.Module):
    def __init__(
        self, in_class: int = 1, n_class: int = 2, dtype: torch.dtype = torch.float32, init_type: str = "kaiming",
        seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        names = ScopeNames()

        def conv(cin, cout, k=3, p=1):
            return names(TorchConv(cin, cout, dtype, init_type, gen, ndim=2, kernel_size=k, padding=p))

        self.features = nn.ModuleList()
        cin, pad = in_class, 100
        for cout, n in STAGES:
            for _ in range(n):
                self.features.append(conv(cin, cout, p=pad))
                cin, pad = cout, 1
        self.fc6 = conv(512, 4096, 7, 0)
        self.fc7 = conv(4096, 4096, 1, 0)
        self.drop6, self.drop7 = Dropout(0.5, generator=gen), Dropout(0.5, generator=gen)
        self.score = conv(4096, n_class, 1, 0)
        k = UPSCORE[0]
        self.upscore_kernel = nn.Parameter(bilinear_kernel((k, k, n_class, n_class)))
        self.flax_params = ("upscore_kernel",)  # read from the model's own Flax scope by convert.py

    @classmethod
    def from_config(cls, config) -> "FCN32s":
        """``FCN32s(in_classes, out_classes)``, the JAX ``from_config`` (no
        ``init_type``: its convs are always kaiming)."""
        from ..registry import model_kwargs

        kw = model_kwargs(config)
        return cls(config.in_classes, config.out_classes, dtype=kw["dtype"], seed=kw["seed"])

    @classmethod
    def from_flax(cls, params, **kwargs) -> "FCN32s":
        """A model of the channels of the JAX FCN32s's params tree; ``kwargs``
        (``dtype``, ...) go to the constructor."""
        return cls(flax_conv_io(params, "TorchConv_0")[0], flax_conv_io(params, "TorchConv_15")[1], **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, convs = x, iter(self.features)
        for _, n in STAGES:
            for _ in range(n):
                h = torch.relu(next(convs)(h))
            h = max_pool_ceil(h)
        h = self.drop6(torch.relu(self.fc6(h)))
        h = self.drop7(torch.relu(self.fc7(h)))
        h = self.score(h)
        _, stride, crop = UPSCORE
        w = self.upscore_kernel.flip((0, 1)).permute(2, 3, 0, 1).to(self.dtype)
        h = F.conv_transpose2d(h.movedim(-1, 1), w, stride=stride).movedim(1, -1)
        return h[:, crop:crop + x.shape[1], crop:crop + x.shape[2]].float()
