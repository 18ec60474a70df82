"""VT-UNet's warm start from a 2-D Swin checkpoint, into the port's model:
the JAX package's ``utils/inflate_vtunet.py`` (the reference's
``SwinTransformerSys3D.inflate_weights``) with the port's parameter names.

* ``patch_embed.proj.weight`` [E, C, kh, kw] gains a depth axis, repeated
  ``kd`` times and divided by ``kd``, into the patch embed's [kd, kh, kw, C,
  E] kernel; where C differs from the model's input channels (a 2-D Swin is
  RGB), the pretrained channels are averaged and broadcast;
* every ``relative_position_bias_table`` [L1, heads] is bicubic-resized in
  its 2-D window plane to (2 wh - 1, 2 ww - 1) where the sizes differ
  (``torch.nn.functional.interpolate(mode='bicubic')``'s arithmetic, as a
  matrix in f64), then tiled (2 wd - 1) times along the depth-major axis,
  the layout of ``nn.attention.relative_position_index``;
* ``relative_position_index`` and ``attn_mask`` buffers are dropped;
* Linear weights [out, in] load transposed into the Dense kernels [in,
  out]; everything else loads name for name where the shapes agree, the
  rest is skipped and reported (the decoder and the head keep their own
  weights).

Usage (a torch checkpoint of a 2-D Swin, e.g. swin_tiny_patch4_window7_224)::

    sd = torch.load("swin_tiny_patch4_window7_224.pth", map_location="cpu")
    sd = sd.get("model", sd)
    state, report = inflate_swin2d_into_vtunet(sd, model)
    model.load_state_dict(state)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _cubic_interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] 1-D bicubic interpolation matrix with
    ``torch.nn.functional.interpolate(mode='bicubic')``'s arithmetic: the
    cubic convolution kernel with A = -0.75, half-pixel source positions
    (align_corners=False), border taps clamped, no antialiasing."""
    a = -0.75

    def k1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for o in range(out_size):
        x = (o + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        t = x - x0
        for tap, c in zip(range(x0 - 1, x0 + 3), (k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t))):
            m[o, min(max(tap, 0), in_size - 1)] += c
    return m


def bicubic_resize_table(table: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """A [L1, heads] bias table whose rows form an S x S grid, bicubic-resized
    to ``out_hw``: [out_h * out_w, heads], f32 (the table itself where the
    sizes agree)."""
    l1, nh = table.shape
    s1 = int(round(l1**0.5))
    if s1 * s1 != l1:
        raise ValueError(f"bias table length {l1} is not a square grid")
    if (s1, s1) == tuple(out_hw):
        return table
    grid = table.astype(np.float64).T.reshape(nh, s1, s1)
    out = np.einsum("oi,nij,pj->nop", _cubic_interp_matrix(s1, out_hw[0]), grid, _cubic_interp_matrix(s1, out_hw[1]))
    return out.reshape(nh, out_hw[0] * out_hw[1]).T.astype(np.float32)


def _effective_window(target_len: int, window_size) -> Tuple[int, int, int]:
    """The largest window, clamped per axis, whose (2w - 1)^3 table has
    ``target_len`` rows (the configured one where none has)."""
    wd, wh, ww = window_size
    best = None
    for d in range(wd, 0, -1):
        for h in range(wh, 0, -1):
            for w in range(ww, 0, -1):
                if (2 * d - 1) * (2 * h - 1) * (2 * w - 1) == target_len and (best is None or (d, h, w) > best):
                    best = (d, h, w)
    return best or tuple(window_size)


# 2-D Swin name (after ``layers.{i}.blocks.{j}.``) -> the port's, and whether a Linear weight is transposed
_BLOCK = {
    "norm1.weight": ("norm1.weight", False), "norm1.bias": ("norm1.bias", False),
    "norm2.weight": ("norm2.weight", False), "norm2.bias": ("norm2.bias", False),
    "attn.qkv.weight": ("attn.qkv.weight", True), "attn.qkv.bias": ("attn.qkv.bias", False),
    "attn.proj.weight": ("attn.proj.weight", True), "attn.proj.bias": ("attn.proj.bias", False),
    "mlp.fc1.weight": ("mlp.fc1.weight", True), "mlp.fc1.bias": ("mlp.fc1.bias", False),
    "mlp.fc2.weight": ("mlp.fc2.weight", True), "mlp.fc2.bias": ("mlp.fc2.bias", False),
}
_DOWNSAMPLE = {
    "reduction.weight": ("reduction.weight", True), "norm.weight": ("norm.weight", False),
    "norm.bias": ("norm.bias", False),
}


def inflate_swin2d_into_vtunet(
    state_dict: Dict[str, object], model: torch.nn.Module, window_size: Tuple[int, int, int] = (7, 7, 7),
    patch_size: Tuple[int, int, int] = (4, 4, 4),
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Inflate a 2-D Swin ``state_dict`` (torch tensors or numpy arrays,
    torch naming) into a copy of the state dict of ``model`` (the port's
    ``VTUNet`` or its ``SwinTransformerSys3D``). Returns (state dict, report:
    one line per tensor, ``loaded: <name>`` or ``skip (...): <name>``)."""
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    prefix = "swin." if any(k.startswith("swin.") for k in state) else ""
    report: List[str] = []
    kd = patch_size[0]
    sd = {k: np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in state_dict.items() if "relative_position_index" not in k and "attn_mask" not in k}

    def put(name: str, value: np.ndarray) -> None:
        key = prefix + name
        if key not in state:
            report.append(f"skip (no param): {key}")
        elif tuple(value.shape) != tuple(state[key].shape):
            report.append(f"skip (shape {value.shape} != {tuple(state[key].shape)}): {key}")
        else:
            state[key] = torch.from_numpy(np.ascontiguousarray(value)).to(state[key].dtype)
            report.append(f"loaded: {key}")

    if "patch_embed.proj.weight" in sd:
        w = sd["patch_embed.proj.weight"]  # [E, C, kh, kw]
        kernel = np.transpose(np.repeat(w[:, :, None], kd, axis=2) / float(kd), (2, 3, 4, 1, 0))  # [kd, kh, kw, C, E]
        want_cin = state[prefix + "patch_embed.weight"].shape[3]
        if kernel.shape[3] != want_cin:
            kernel = np.broadcast_to(kernel.mean(axis=3, keepdims=True),
                                     kernel.shape[:3] + (want_cin,) + kernel.shape[4:]).copy()
            report.append(f"patch_embed: averaged {w.shape[1]} pretrained input channels into {want_cin}")
        put("patch_embed.weight", kernel)
    if "patch_embed.proj.bias" in sd:
        put("patch_embed.bias", sd["patch_embed.proj.bias"])
    if "patch_embed.norm.weight" in sd:
        put("patch_norm.weight", sd["patch_embed.norm.weight"])
        put("patch_norm.bias", sd["patch_embed.norm.bias"])

    for key, value in sorted(sd.items()):
        if not key.startswith("layers."):
            continue
        parts = key.split(".")
        stage = parts[1]
        if parts[2] == "blocks":
            scope, rest = f"layers.{stage}.blocks.{parts[3]}.", ".".join(parts[4:])
            if rest == "attn.relative_position_bias_table":
                table = state.get(prefix + scope + "attn.relative_position_bias_table")
                ewd, ewh, eww = (_effective_window(table.shape[0], window_size) if table is not None
                                 else tuple(window_size))
                resized = bicubic_resize_table(value, (2 * ewh - 1, 2 * eww - 1))
                put(scope + rest, np.tile(resized, (2 * ewd - 1, 1)))  # depth-major blocks
            elif rest in _BLOCK:
                name, transpose = _BLOCK[rest]
                put(scope + name, value.T if transpose else value)
            else:
                report.append(f"skip (unmapped): {key}")
        elif parts[2] == "downsample" and ".".join(parts[3:]) in _DOWNSAMPLE:
            name, transpose = _DOWNSAMPLE[".".join(parts[3:])]
            put(f"layers.{stage}.downsample.{name}", value.T if transpose else value)
        else:
            report.append(f"skip (unmapped): {key}")
    return state, report
