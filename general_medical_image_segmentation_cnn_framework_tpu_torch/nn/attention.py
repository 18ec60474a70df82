"""Attention blocks of the transformers, channels-last, as the JAX package's
``nn/attention.py``: the Swin-3D toolkit of VT-UNet (``WindowAttention3D``
with its relative position bias and the decoder's cross-attention against
cached encoder V/K/Q, ``SwinTransformerBlock3D``, ``window_partition`` /
``window_reverse`` / ``get_window_size`` / ``compute_mask``,
``PositionalEncoding3D``), ``DropPath`` and ``Mlp``, and UNETR's plain
multi-head self-attention (``ViTSelfAttention``: ``_SelfAttention``, the
JAX class name, which fixes its Flax scope).

The JAX package computes all of it with XLA einsums outside any Pallas
kernel; here it is ``torch.matmul`` and a softmax in f32 (f64 for an f64
model, which the tests hold to the JAX package in f64). The softmax's
input is the scores plus the relative position bias (a trained parameter,
whose gradient flows through the plain ops) and the cyclic-shift mask.

Reproduced as the JAX package has them: the decoder's cross-attention query
is scaled twice; the bias table is sized for the configured window and
sliced ``[:n, :n]`` when a small grid clamps the window; padded tokens are
zeros after ``norm1`` and are not masked; the masked logits get -100, not
-inf; ``forward_part3`` blends at 0.5 and reuses the block's own ``norm2``
and MLP on the positional encoding. Modules record their Flax scope
(``nn.blocks.ScopeNames``) so that ``convert.py`` carries the weights.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Dense, Dropout, ScopeNames, _generator
from .init import truncated_normal
from .norm import LayerNorm, _stat


class DropPath(Dropout):
    """Per-sample stochastic depth (timm's DropPath) on [B, D, H, W, C]: one
    draw per sample, kept with probability 1 - rate and scaled by
    1 / (1 - rate), from this module's own generator (``Dropout``'s)."""

    def __init__(self, rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__(rate, broadcast_dims=(1, 2, 3, 4), generator=generator)


class Mlp(nn.Module):
    """Dense -> exact GELU -> Dropout -> Dense -> Dropout (``Dense_0``, ``Dense_1``)."""

    def __init__(self, dim: int, hidden: int, out: int, drop: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        names = ScopeNames()
        self.fc1 = names(Dense(dim, hidden, dtype, generator))
        self.fc2 = names(Dense(hidden, out, dtype, generator))
        self.drop1 = Dropout(drop, generator=generator)
        self.drop2 = Dropout(drop, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(F.gelu(self.fc1(x), approximate="none"))
        return self.drop2(self.fc2(x))


def window_partition(x: torch.Tensor, window_size: Sequence[int]) -> torch.Tensor:
    """[B, D, H, W, C] -> [B * nW, wd * wh * ww, C]."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window_size
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window_size: Sequence[int], b: int, d: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``window_partition``: [B * nW, N, C] -> [B, D, H, W, C]."""
    wd, wh, ww = window_size
    x = windows.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, -1).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, -1)


def get_window_size(x_size, window_size, shift_size=None):
    """The window clamped to the input's extent on each axis where the extent
    is at most the window (equality clamps too), that axis's shift zeroed."""
    use_ws = list(window_size)
    use_ss = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_ws[i] = x_size[i]
            if use_ss is not None:
                use_ss[i] = 0
    if use_ss is None:
        return tuple(use_ws)
    return tuple(use_ws), tuple(use_ss)


@lru_cache()
def window_region_ids(dp: int, hp: int, wp: int, window_size: Tuple[int, ...],
                      shift_size: Tuple[int, ...]) -> np.ndarray:
    """The window-partitioned cyclic-shift region ids [nW, N] of a padded
    (dp, hp, wp) grid: numpy, small (nW * N integers), cached. Callers must
    not write to it."""
    img_mask = np.zeros((dp, hp, wp), np.float32)
    cnt = 0
    regions = [
        (slice(-window_size[i]),
         slice(-window_size[i], -shift_size[i]) if shift_size[i] else slice(0, 0),
         slice(-shift_size[i], None) if shift_size[i] else slice(0, 0))
        for i in range(3)
    ]
    for d in regions[0]:
        for h in regions[1]:
            for w in regions[2]:
                img_mask[d, h, w] = cnt
                cnt += 1
    wd, wh, ww = window_size
    m = img_mask.reshape(dp // wd, wd, hp // wh, wh, wp // ww, ww).transpose(0, 2, 4, 1, 3, 5)
    return m.reshape(-1, wd * wh * ww)


def compute_mask(dp: int, hp: int, wp: int, window_size, shift_size, device=None) -> torch.Tensor:
    """The cyclic shift's attention mask [nW, N, N], f32: -100 where two
    positions of a window come from different shift regions, else 0. Made on
    ``device`` from the small cached id grid (the pairwise tensor is nW * N^2)."""
    m = torch.from_numpy(window_region_ids(dp, hp, wp, tuple(window_size), tuple(shift_size))).to(device)
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(torch.float32)


def relative_position_index(window_size: Sequence[int]) -> np.ndarray:
    """[N, N] index into the (2wd-1)(2wh-1)(2ww-1)-row bias table of each
    pair of positions of a window (the JAX ``_relative_position_index``)."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


class WindowAttention3D(nn.Module):
    """Window multi-head self-attention with a relative position bias, and,
    given ``prev`` (the cached encoder (v, k, q)), the decoder's
    cross-attention of this block's query (scaled a second time, as in the
    JAX package; the cached q is unused) against the cached k and v.
    ``Dense_0`` is the qkv projection, ``Dense_1`` the output projection;
    ``relative_position_bias_table`` [(2w-1)^3, heads] is its own parameter,
    sized for the configured ``window_size``.

    ``forward(x [B_, N, C], mask [nW, N, N] or None, prev)`` returns (out,
    the cross-attention's out or None, v, k, q)."""

    def __init__(self, dim: int, window_size: Sequence[int], num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.num_heads = dtype, num_heads
        self.scale = (dim // num_heads) ** -0.5
        ws = tuple(window_size)
        gen = _generator(generator)
        self.relative_position_bias_table = nn.Parameter(
            truncated_normal(((2 * ws[0] - 1) * (2 * ws[1] - 1) * (2 * ws[2] - 1), num_heads), gen, 0.02))
        self.flax_params = ("relative_position_bias_table",)  # read from this module's Flax scope by convert.py
        self.register_buffer("relative_index", torch.from_numpy(relative_position_index(ws)), persistent=False)
        names = ScopeNames()
        self.qkv = names(Dense(dim, 3 * dim, dtype, gen, use_bias=qkv_bias))
        self.proj = names(Dense(dim, dim, dtype, gen))
        self.attn_drop = Dropout(attn_drop, generator=gen)
        self.proj_drop = Dropout(proj_drop, generator=gen)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, prev=None):
        b_, n, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(b_, n, 3, h, c // h).permute(2, 0, 3, 1, 4).unbind(0)  # [B_, nH, N, hd]
        q = q * self.scale
        index = self.relative_index[:n, :n].reshape(-1)
        bias = _stat(self.relative_position_bias_table[index].reshape(n, n, h).permute(2, 0, 1)[None])

        def attend(query, key, value):
            attn = _stat(query @ key.transpose(-2, -1)) + bias
            if mask is not None:
                nw = mask.shape[0]
                attn = (attn.reshape(b_ // nw, nw, h, n, n) + mask[None, :, None].to(attn.dtype)).reshape(-1, h, n, n)
            attn = self.attn_drop(attn.softmax(dim=-1).to(self.dtype))
            out = (attn @ value).transpose(1, 2).reshape(b_, n, c)
            return self.proj_drop(self.proj(out))

        out = attend(q, k, v)
        out2 = None
        if prev is not None:
            prev_v, prev_k, _ = prev
            out2 = attend(q * self.scale, prev_k, prev_v)  # the query scaled twice, as in the JAX package
        return out, out2, v, k, q


class PositionalEncoding3D:
    """Sinusoidal 3-D positional encoding of a [B, X, Y, Z] grid: the
    per-axis sin/cos tables in numpy f32 (as the JAX package computes them,
    on the host), broadcast and concatenated on ``device``: [B, X, Y, Z,
    orig_ch], f32."""

    def __init__(self, channels: int):
        ch = int(np.ceil(channels / 6) * 2)
        if ch % 2:
            ch += 1
        self.channels = ch
        self.inv_freq = 1.0 / (10000 ** (np.arange(0, ch, 2, dtype=np.float32) / ch))

    def _axis(self, length: int, device) -> torch.Tensor:
        sin_inp = np.einsum("i,j->ij", np.arange(length, dtype=np.float32), self.inv_freq)
        return torch.from_numpy(np.concatenate([np.sin(sin_inp), np.cos(sin_inp)], axis=-1)).to(device)

    def __call__(self, shape, orig_ch: int, device=None) -> torch.Tensor:
        b, x, y, z = shape
        c = self.channels
        ex = self._axis(x, device)[:, None, None, :].expand(x, y, z, c)
        ey = self._axis(y, device)[None, :, None, :].expand(x, y, z, c)
        ez = self._axis(z, device)[None, None, :, :].expand(x, y, z, c)
        emb = torch.cat([ex, ey, ez], dim=-1)[..., :orig_ch]
        return emb[None].expand(b, x, y, z, orig_ch)


class SwinTransformerBlock3D(nn.Module):
    """One (shifted-)window transformer block: ``LayerNorm_0`` (norm1),
    ``LayerNorm_1`` (norm2), ``Mlp_0`` and ``WindowAttention3D_0``, in the
    JAX package's order of creation. ``forward(x [B, D, H, W, C],
    mask_matrix, prev)`` returns (x, v, k, q); with ``prev`` (a decoder
    block) the cross-attention branch and ``forward_part3``'s blend run
    too. The window is clamped to the grid per call (``get_window_size``);
    the attention keeps the configured window's bias table."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int] = (7, 7, 7),
                 shift_size: Sequence[int] = (0, 0, 0), mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        gen = _generator(generator)
        names = ScopeNames()
        self.norm1 = names(LayerNorm(dim, dtype=dtype))
        self.norm2 = names(LayerNorm(dim, dtype=dtype))
        self.mlp = names(Mlp(dim, int(dim * mlp_ratio), dim, drop, dtype, gen))
        self.attn = names(WindowAttention3D(dim, window_size, num_heads, qkv_bias, attn_drop, drop, dtype, gen))
        self.drop_path = DropPath(drop_path, gen)

    def forward(self, x: torch.Tensor, mask_matrix: torch.Tensor, prev=None):
        b, d, h, w, c = x.shape
        window_size, shift_size = get_window_size((d, h, w), self.window_size, self.shift_size)
        shifted = any(s > 0 for s in shift_size)
        shortcut = x
        y = self.norm1(x)
        pad = [(window_size[i] - n % window_size[i]) % window_size[i] for i, n in enumerate((d, h, w))]
        y = F.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))  # zeros after norm1, not masked
        _, dp, hp, wp, _ = y.shape
        if shifted:
            y = torch.roll(y, tuple(-s for s in shift_size), (1, 2, 3))
        aw, caw, v, k, q = self.attn(window_partition(y, window_size), mask_matrix if shifted else None, prev)

        def merge(wins):
            z = window_reverse(wins, window_size, b, dp, hp, wp)
            if shifted:
                z = torch.roll(z, shift_size, (1, 2, 3))
            return z[:, :d, :h, :w, :]

        x = shortcut + self.drop_path(merge(aw))
        x = x + self.drop_path(self.mlp(self.norm2(x)))
        if caw is not None:
            alpha = 0.5
            y2 = shortcut + self.drop_path(merge(caw))
            y2 = y2 + self.drop_path(self.mlp(self.norm2(y2)))
            fpe = PositionalEncoding3D(c)((b, d, h, w), c, x.device).to(x.dtype)
            x = (1 - alpha) * x + alpha * y2 + self.mlp(self.norm2(fpe))  # forward_part3: the block's norm2 + MLP
        return x, v, k, q


class _SelfAttention(nn.Module):
    """UNETR's multi-head self-attention (``ViTSelfAttention``; the class
    name is the JAX one, which names its Flax scope): q, k, v and the output
    projection are ``Dense_0`` .. ``Dense_3``; the scores are a ``dtype``
    matmul, raised to f32 (f64 for an f64 model) and divided by
    sqrt(head_dim) there (the JAX package divides by a numpy float64, which
    promotes a bf16 product to f32), the softmax runs in that precision and
    the probabilities go back to ``dtype``; dropout on the probabilities and
    on the output."""

    def __init__(self, num_heads: int, embed_dim: int, dropout: float, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.embed_dim, self.dtype = num_heads, embed_dim, dtype
        gen = _generator(generator)
        names = ScopeNames()
        self.query, self.key, self.value, self.out = (names(Dense(embed_dim, embed_dim, dtype, gen)) for _ in range(4))
        self.attn_drop = Dropout(dropout, generator=gen)
        self.out_drop = Dropout(dropout, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        hd = self.embed_dim // self.num_heads

        def heads(t):
            return t.reshape(b, n, self.num_heads, hd).transpose(1, 2)  # [B, H, N, hd]

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scores = _stat(q @ k.transpose(-2, -1)) / math.sqrt(hd)
        probs = self.attn_drop(scores.softmax(dim=-1).to(self.dtype))
        ctx = (probs @ v).transpose(1, 2).reshape(b, n, self.embed_dim)
        return self.out_drop(self.out(ctx))


ViTSelfAttention = _SelfAttention
