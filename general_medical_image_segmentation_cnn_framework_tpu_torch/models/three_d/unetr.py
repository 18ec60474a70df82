"""UNETR: a ViT encoder and a conv / deconv decoder pyramid, channels-last,
as the JAX package's ``models/three_d/unetr.py``: a k16 s16 patch embed
(``F.conv3d``) with learned position embeddings, 12 pre-norm transformer
blocks (``nn.attention.ViTSelfAttention``; a 2048-wide ReLU feed-forward),
the hidden states of layers 3, 6, 9 and 12 fed through k2 s2 up-convs
(``TorchConvTranspose``'s matmul route) and 17 k3 s1 p1 Conv -> BatchNorm
-> ReLU blocks, which run the hand-written conv kernels, and a 1x1x1 head.

``position_embeddings`` [1, n_patches, embed] fix the token count to that
of ``img_shape`` (``config.patch_size``), so an input of any other spatial
shape is refused (the JAX model fails on it too); a whole-volume predict
of another shape therefore fails with that error.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...nn.attention import ViTSelfAttention
from ...nn.blocks import ConvBlock, Dense, Dropout, ScopeNames, TorchConv, TorchConvTranspose, flax_conv_io
from ...nn.norm import LayerNorm


class _ConvBNReLU(ConvBlock):
    """The k3 s1 p1 Conv -> BatchNorm -> ReLU block (``ConvBlock`` under the JAX class name)."""


class _DeconvBlock(nn.Module):
    """k2 s2 up-conv (``TorchConvTranspose_0``) -> ``_ConvBNReLU_0``."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype, init_type: str, gen: torch.Generator):
        super().__init__()
        self.up = TorchConvTranspose(cin, cout, dtype, init_type, gen)
        self.up.scope = "TorchConvTranspose_0"
        self.block = _ConvBNReLU(cout, cout, dtype, init_type, gen)
        self.block.scope = "_ConvBNReLU_0"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(self.up(x))


class _TransformerBlock(nn.Module):
    """Pre-norm block: LayerNorm (eps 1e-6) -> self-attention -> residual;
    LayerNorm -> Dense(2048) -> ReLU -> Dropout(0.1) -> Dense -> residual."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float, dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        names = ScopeNames()
        self.norm1 = names(LayerNorm(embed_dim, dtype=dtype))
        self.attn = names(ViTSelfAttention(num_heads, embed_dim, dropout, dtype, gen))
        self.norm2 = names(LayerNorm(embed_dim, dtype=dtype))
        self.ff1 = names(Dense(embed_dim, 2048, dtype, gen))
        self.ff2 = names(Dense(2048, embed_dim, dtype, gen))
        self.ff_drop = Dropout(0.1, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(self.norm1(x)) + x
        return self.ff2(self.ff_drop(torch.relu(self.ff1(self.norm2(x))))) + x


def _run(seq, y):
    for m in seq:
        y = m(y)
    return y


class UNETR(nn.Module):
    def __init__(
        self, img_shape: Sequence[int] = (128, 128, 128), input_dim: int = 4, output_dim: int = 3,
        embed_dim: int = 768, patch_size: int = 16, num_heads: int = 12, dropout: float = 0.1,
        num_layers: int = 12, dtype: torch.dtype = torch.float32, init_type: str = "none", seed: int = 0,
    ):
        super().__init__()
        self.dtype, self.embed_dim = dtype, embed_dim
        self.img_shape = tuple(int(s) for s in img_shape)
        self.patch_dim = tuple(s // patch_size for s in self.img_shape)
        gen = torch.Generator().manual_seed(seed)
        convs, ups, deconvs, blocks, layers = (ScopeNames() for _ in range(5))
        self.patch_embed = convs(TorchConv(input_dim, embed_dim, dtype, init_type, gen, kernel_size=patch_size,
                                           stride=patch_size, padding=0))
        self.position_embeddings = nn.Parameter(torch.zeros(1, math.prod(self.patch_dim), embed_dim))
        self.flax_params = ("position_embeddings",)  # read from the model's own Flax scope by convert.py
        self.token_drop = Dropout(dropout, generator=gen)
        self.layers = nn.ModuleList(
            layers(_TransformerBlock(embed_dim, num_heads, dropout, dtype, gen)) for _ in range(num_layers))

        def stack(names, block, cin, widths):
            out = nn.ModuleList()
            for f in widths:
                out.append(names(block(cin, f, dtype, init_type, gen)))
                cin = f
            return out

        e = embed_dim
        # in the JAX call order, which numbers the scopes
        self.up12 = ups(TorchConvTranspose(e, 512, dtype, init_type, gen))
        self.dec9 = stack(deconvs, _DeconvBlock, e, (512,))
        self.conv9 = stack(blocks, _ConvBNReLU, 1024, (512, 512, 512))
        self.up9 = ups(TorchConvTranspose(512, 256, dtype, init_type, gen))
        self.dec6 = stack(deconvs, _DeconvBlock, e, (512, 256))
        self.conv6 = stack(blocks, _ConvBNReLU, 512, (256, 256))
        self.up6 = ups(TorchConvTranspose(256, 128, dtype, init_type, gen))
        self.dec3 = stack(deconvs, _DeconvBlock, e, (512, 256, 128))
        self.conv3 = stack(blocks, _ConvBNReLU, 256, (128, 128))
        self.up3 = ups(TorchConvTranspose(128, 64, dtype, init_type, gen))
        self.conv0 = stack(blocks, _ConvBNReLU, input_dim, (32, 64))
        self.conv_out = stack(blocks, _ConvBNReLU, 128, (64, 64))
        self.head = convs(TorchConv(64, output_dim, dtype, init_type, gen, kernel_size=1))

    @classmethod
    def from_config(cls, config) -> "UNETR":
        """``UNETR(img_shape=patch_size, in_classes, out_classes)``, the JAX ``from_config``."""
        from ..registry import model_kwargs

        return cls(tuple(config.patch_size), config.in_classes, config.out_classes, **model_kwargs(config))

    @classmethod
    def from_flax(cls, params, **kwargs) -> "UNETR":
        """A model of the widths of the JAX UNETR's params tree; ``kwargs``
        (``dtype``, ``num_heads``: the tree does not hold the heads, 12 in
        every JAX ``from_config``) go to the constructor. The tree holds the
        patch count, not the grid's shape: the grid is a cube where the
        count is one, else n x 1 x 1 (the parameters are the same)."""
        cin, embed = flax_conv_io(params, "TorchConv_0")
        patch = params["TorchConv_0"].get("Conv_0", params["TorchConv_0"])["kernel"].shape[0]
        n = int(params["position_embeddings"].shape[1])
        side = round(n ** (1 / 3))
        grid = (side,) * 3 if side**3 == n else (n, 1, 1)
        layers = sum(1 for k in params if k.startswith("_TransformerBlock_"))
        return cls(tuple(g * patch for g in grid), cin, flax_conv_io(params, "TorchConv_1")[1], embed, patch,
                   num_layers=layers, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:4]) != self.img_shape:
            raise ValueError(
                f"UNETR's position_embeddings fix its input to img_shape {self.img_shape} "
                f"({self.position_embeddings.shape[1]} patches); got spatial {tuple(x.shape[1:4])}")
        tokens = self.patch_embed(x)
        b = tokens.shape[0]
        tokens = tokens.reshape(b, -1, self.embed_dim)
        tokens = self.token_drop(tokens + self.position_embeddings.to(tokens.dtype))
        extracted = []
        for depth, layer in enumerate(self.layers):
            tokens = layer(tokens)
            if depth + 1 in (3, 6, 9, 12):
                extracted.append(tokens)
        z3, z6, z9, z12 = (t.reshape(b, *self.patch_dim, self.embed_dim) for t in extracted)
        y = _run(self.conv9, torch.cat([_run(self.dec9, z9), self.up12(z12)], dim=-1))
        y = _run(self.conv6, torch.cat([_run(self.dec6, z6), self.up9(y)], dim=-1))
        y = _run(self.conv3, torch.cat([_run(self.dec3, z3), self.up6(y)], dim=-1))
        y = _run(self.conv_out, torch.cat([_run(self.conv0, x), self.up3(y)], dim=-1))
        return self.head(y).float()
