"""VT-UNet's 3-D Swin-Transformer U-Net, channels-last, as the JAX package's
``models/three_d/vt_unet.py``: a k4 s4 patch embed (+ LayerNorm) as one
matmul over space-to-depth patches, encoder stages of shifted-window blocks
(``nn.attention``) with ``PatchMerging`` over H and W, decoder stages whose
blocks also cross-attend to the cached encoder V/K (``BasicLayerUp``),
``PatchExpand`` over H and W, ``FinalPatchExpandX4`` and a 1x1x1 head (a
matmul). The depth axis D is never downsampled; an input not divisible by
the patch is zero-padded up first, and the output lives at that padded
resolution. No k3 s1 conv: the network runs no conv kernel, only the loss
kernels in training.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.attention import SwinTransformerBlock3D, compute_mask, get_window_size
from ...nn.blocks import Dense, Dropout, ScopeNames, _generator
from ...nn.norm import LayerNorm


class _MatmulConv(Dense):
    """Conv with stride = kernel and no padding as one matmul: the
    [N * D/kd * H/kh * W/kw, kd*kh*kw*Cin] space-to-depth patches times the
    kernel [kd, kh, kw, Cin, Cout] flattened (a Dense over the patches,
    LeCun-normal over the same fan-in), plus ``bias``."""

    def __init__(self, cin: int, cout: int, kernel_size: Sequence[int], dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, use_bias: bool = True):
        kernel_size = tuple(int(k) for k in kernel_size)
        super().__init__(math.prod(kernel_size) * cin, cout, dtype, generator, use_bias)
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(self.weight.detach().reshape(*kernel_size, cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, d, h, w, cin = x.shape
        kd, kh, kw = self.kernel_size
        x = x.to(self.dtype).reshape(n, d // kd, kd, h // kh, kh, w // kw, kw, cin).permute(0, 1, 3, 5, 2, 4, 6, 7)
        y = x.reshape(n, d // kd, h // kh, w // kw, -1) @ self.weight.reshape(-1, self.weight.shape[-1]).to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class PatchMerging(nn.Module):
    """Merge 2x2 over H and W (odd H or W zero-padded first; D untouched):
    LayerNorm over the 4C channels, then a bias-free Dense to 2C."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        names = ScopeNames()
        self.norm = names(LayerNorm(4 * dim, dtype=dtype))
        self.reduction = names(Dense(4 * dim, 2 * dim, dtype, generator, use_bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchExpand(nn.Module):
    """Expand H and W by 2: a bias-free Dense dim -> 2 dim, the 2x2 pixel
    shuffle to dim / 2 channels, LayerNorm (D passes through)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        names = ScopeNames()
        self.expand = names(Dense(dim, 2 * dim, dtype, generator, use_bias=False))
        self.norm = names(LayerNorm(dim // 2, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, _ = x.shape
        x = self.expand(x)
        c = x.shape[-1] // 4
        x = x.reshape(b, d, h, w, 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6).reshape(b, d, 2 * h, 2 * w, c)
        return self.norm(x)


class FinalPatchExpandX4(nn.Module):
    """Expand D, H and W by 4: a bias-free Dense dim -> 64 dim, the 4x4x4
    pixel shuffle to dim channels, LayerNorm."""

    def __init__(self, dim: int, dim_scale: int = 4, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = dim_scale
        names = ScopeNames()
        self.expand = names(Dense(dim, 4 * 16 * dim, dtype, generator, use_bias=False))
        self.norm = names(LayerNorm(4 * 16 * dim // dim_scale**3, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, _ = x.shape
        p = self.p
        x = self.expand(x)
        c = x.shape[-1] // p**3
        x = x.reshape(b, d, h, w, p, p, p, c).permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d * p, h * p, w * p, c)
        return self.norm(x)


def _stage_mask(x: torch.Tensor, window_size: Sequence[int]) -> torch.Tensor:
    """The shifted blocks' mask of a stage over x's grid padded to the clamped window."""
    _, d, h, w, _ = x.shape
    shift = tuple(i // 2 for i in window_size)
    ws, ss = get_window_size((d, h, w), window_size, shift)
    padded = [int(np.ceil(n / k)) * k for n, k in zip((d, h, w), ws)]
    return compute_mask(*padded, ws, ss, device=x.device)


def _blocks(dim, depth, num_heads, window_size, mlp_ratio, qkv_bias, drop, attn_drop, drop_path, dtype, gen):
    names = ScopeNames()
    shift = tuple(i // 2 for i in window_size)
    return nn.ModuleList(
        names(SwinTransformerBlock3D(
            dim, num_heads, window_size, (0, 0, 0) if i % 2 == 0 else shift, mlp_ratio, qkv_bias, drop, attn_drop,
            drop_path[i] if i < len(drop_path) else drop_path[-1], dtype, gen))
        for i in range(depth))


class BasicLayer(nn.Module):
    """An encoder stage: blocks alternating unshifted / shifted, each even
    and odd block's (v, k, q) cached for the decoder (the last of each
    parity), then ``PatchMerging`` where ``has_downsample``. Returns (x,
    the stage's output before the merge, cache of the even blocks, cache of
    the odd ones)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Sequence[int] = (7, 7, 7),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: Sequence[float] = (0.0,), has_downsample: bool = False,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.blocks = _blocks(dim, depth, num_heads, window_size, mlp_ratio, qkv_bias, drop, attn_drop,
                              drop_path, dtype, generator)
        self.downsample = None
        if has_downsample:
            self.downsample = PatchMerging(dim, dtype, generator)
            self.downsample.scope = "PatchMerging_0"

    def forward(self, x: torch.Tensor):
        mask = _stage_mask(x, self.window_size)
        cached = [(None,) * 3, (None,) * 3]
        for i, blk in enumerate(self.blocks):
            x, v, k, q = blk(x, mask)
            cached[i % 2] = (v, k, q)
        skip = x
        if self.downsample is not None:
            x = self.downsample(x)
        return x, skip, cached[0], cached[1]


class BasicLayerUp(nn.Module):
    """A decoder stage: blocks alternating unshifted / shifted, block i
    cross-attending to ``prev1`` (even i) or ``prev2`` (odd i), then
    ``PatchExpand(dim)`` where ``has_upsample``."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Sequence[int] = (7, 7, 7),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: Sequence[float] = (0.0,), has_upsample: bool = False,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.blocks = _blocks(dim, depth, num_heads, window_size, mlp_ratio, qkv_bias, drop, attn_drop,
                              drop_path, dtype, generator)
        self.upsample = None
        if has_upsample:
            self.upsample = PatchExpand(dim, dtype, generator)
            self.upsample.scope = "PatchExpand_0"

    def forward(self, x: torch.Tensor, prev1, prev2) -> torch.Tensor:
        mask = _stage_mask(x, self.window_size)
        for i, blk in enumerate(self.blocks):
            x = blk(x, mask, prev1 if i % 2 == 0 else prev2)[0]
        return x if self.upsample is None else self.upsample(x)


class SwinTransformerSys3D(nn.Module):
    """The U-Net, in the JAX module's order of scopes: the patch embed
    (``Conv_0``) and its LayerNorm, the encoder stages, a LayerNorm,
    ``PatchExpand``, per decoder stage the concat with the encoder stage's
    input, a bias-free Dense and ``BasicLayerUp``, a LayerNorm,
    ``FinalPatchExpandX4`` and the bias-free 1x1x1 head (``Conv_1``).
    Returns f32 logits."""

    def __init__(
        self, patch_size: Sequence[int] = (4, 4, 4), in_chans: int = 4, num_classes: int = 3, embed_dim: int = 96,
        depths: Sequence[int] = (2, 2, 2, 1), num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size: Sequence[int] = (7, 7, 7), mlp_ratio: float = 4.0, qkv_bias: bool = True,
        drop_rate: float = 0.0, attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
        dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.dtype = dtype
        n = len(depths)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        gen = _generator(generator)
        norms, layers, ups, denses, expands = (ScopeNames() for _ in range(5))
        self.patch_embed = _MatmulConv(in_chans, embed_dim, self.patch_size, dtype, gen)
        self.patch_embed.scope = "Conv_0"
        self.patch_norm = norms(LayerNorm(embed_dim, dtype=dtype))
        self.pos_drop = Dropout(drop_rate, generator=gen)
        common = dict(window_size=window_size, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, drop=drop_rate,
                      attn_drop=attn_drop_rate, dtype=dtype, generator=gen)
        self.layers = nn.ModuleList(
            layers(BasicLayer(int(embed_dim * 2**i), depths[i], num_heads[i],
                              drop_path=dpr[sum(depths[:i]):sum(depths[:i + 1])], has_downsample=i < n - 1,
                              **common))
            for i in range(n))
        self.norm = norms(LayerNorm(int(embed_dim * 2 ** (n - 1)), dtype=dtype))
        # the decoder, in the JAX call order: PatchExpand; then per stage its Dense and BasicLayerUp
        self.first_expand = expands(PatchExpand(int(embed_dim * 2 ** (n - 1)), dtype, gen))
        self.concat_back = nn.ModuleList()
        self.layers_up = nn.ModuleList()
        for inx in range(1, n):
            dim, i = int(embed_dim * 2 ** (n - 1 - inx)), n - 1 - inx
            self.concat_back.append(denses(Dense(2 * dim, dim, dtype, gen, use_bias=False)))
            self.layers_up.append(ups(BasicLayerUp(dim, depths[i], num_heads[i],
                                                   drop_path=dpr[sum(depths[:i]):sum(depths[:i + 1])],
                                                   has_upsample=inx < n - 1, **common)))
        self.norm_up = norms(LayerNorm(embed_dim, dtype=dtype))
        self.final_expand = expands(FinalPatchExpandX4(embed_dim, 4, dtype, gen))
        self.head = _MatmulConv(embed_dim, num_classes, (1, 1, 1), dtype, gen, use_bias=False)
        self.head.scope = "Conv_1"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = [(-x.shape[1 + i]) % self.patch_size[i] for i in range(3)]
        if any(pads):  # the patch embed zero-pads up to a multiple of the patch
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        y = self.pos_drop(self.patch_norm(self.patch_embed(x)))
        skips, caches = [], []
        for layer in self.layers:
            skips.append(y)  # the stage's input
            y, _, c1, c2 = layer(y)
            caches.append((c1, c2))
        y = self.first_expand(self.norm(y))
        n = len(self.layers)
        for inx, (dense, layer) in enumerate(zip(self.concat_back, self.layers_up), start=1):
            y = dense(torch.cat([y, skips[n - 1 - inx]], dim=-1))
            y = layer(y, *caches[n - 1 - inx])
        y = self.final_expand(self.norm_up(y))
        return self.head(y).float()

