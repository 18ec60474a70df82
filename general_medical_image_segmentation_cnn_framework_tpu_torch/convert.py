"""Carry UNet3D weights from the JAX package to the port.

``unet3d_state_dict_from_flax`` maps the Flax variable tree onto the port's
``state_dict``. The port keeps the Flax layouts (conv kernels
[kd, kh, kw, Cin, Cout]), so only names change, plus the 1x1x1 head, which
becomes an ``nn.Linear``.

``read_flax_msgpack`` reads a JAX ``.ckpt`` (``checkpoint.save_checkpoint``
of the JAX package: flax msgpack of {params, batch_stats, opt_state, epoch})
with ``msgpack`` alone, and ``convert_checkpoint`` writes the port's
checkpoint from it::

    python -m general_medical_image_segmentation_cnn_framework_tpu_torch.convert \\
        latest_checkpoint.ckpt unet3d.pt
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .checkpoint import save_checkpoint

N_BLOCKS = 18
N_UPS = 4

# flax msgpack extension types (flax.serialization._MsgpackExtType)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def convblock_state_dict_from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """One Flax ``ConvBlock`` scope -> the port ConvBlock's state_dict."""
    conv, bn, stats = params["TorchConv_0"], params["BatchNorm_0"], batch_stats["BatchNorm_0"]
    return {
        "conv.weight": _t(conv["kernel"]),
        "conv.bias": _t(conv["bias"]),
        "bn.weight": _t(bn["scale"]),
        "bn.bias": _t(bn["bias"]),
        "bn.running_mean": _t(stats["mean"]),
        "bn.running_var": _t(stats["var"]),
    }


def unet3d_state_dict_from_flax(
    params: Mapping, batch_stats: Mapping
) -> Dict[str, torch.Tensor]:
    """Flax UNet3D ``params``/``batch_stats`` (numpy leaves) -> port state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(N_BLOCKS):
        block = convblock_state_dict_from_flax(params[f"ConvBlock_{i}"], batch_stats[f"ConvBlock_{i}"])
        sd.update({f"blocks.{i}.{k}": v for k, v in block.items()})
    for i in range(N_UPS):
        up = params[f"TorchConvTranspose_{i}"]
        sd[f"ups.{i}.weight"] = _t(up["kernel"])
        sd[f"ups.{i}.bias"] = _t(up["bias"])
    head = params["Conv_0"]
    kernel = np.asarray(head["kernel"], dtype=np.float32)  # [1, 1, 1, Cin, Cout]
    sd["head.weight"] = _t(kernel.reshape(kernel.shape[-2], kernel.shape[-1]).T)
    sd["head.bias"] = _t(head["bias"])
    return sd


def _ndarray(data: bytes, msgpack) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays in a JAX checkpoint are not supported; save it in float32")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def read_flax_msgpack(path: Union[str, Path]) -> Dict:
    """Read a flax msgpack checkpoint into nested dicts of numpy arrays."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading a JAX .ckpt needs the 'msgpack' package") from e

    def ext_hook(code: int, data: bytes):
        if code == _EXT_NDARRAY:
            return _ndarray(data, msgpack)
        if code == _EXT_NPSCALAR:
            return _ndarray(data, msgpack)[()]
        raise ValueError(f"{path}: unsupported msgpack extension type {code}")

    with open(path, "rb") as f:
        state = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    if _has_chunked(state):
        raise ValueError(f"{path}: chunked arrays (over 1 GiB) are not supported")
    return state


def _has_chunked(tree) -> bool:
    if isinstance(tree, dict):
        return "__msgpack_chunked_array__" in tree or any(_has_chunked(v) for v in tree.values())
    return False


def convert_checkpoint(src: Union[str, Path], dst: Union[str, Path]) -> None:
    """JAX UNet3D ``.ckpt`` -> the port's checkpoint at ``dst``."""
    state = read_flax_msgpack(src)
    sd = unet3d_state_dict_from_flax(state["params"], state["batch_stats"])
    save_checkpoint(dst, sd, int(state.get("epoch", 0)))


def main(argv: Optional[list] = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        raise SystemExit("usage: python -m general_medical_image_segmentation_cnn_framework_tpu_torch.convert SRC.ckpt DST.pt")
    convert_checkpoint(args[0], args[1])


if __name__ == "__main__":
    main()
