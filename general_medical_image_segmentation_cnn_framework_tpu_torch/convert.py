"""Carry UNet3D and UNet2D weights from the JAX package to the port.

``unet3d_state_dict_from_flax`` and ``unet2d_state_dict_from_flax`` map the
Flax variable tree (params and batch_stats) onto the port's
``state_dict``. The port keeps the Flax layouts (conv kernels
[kd, kh, kw, Cin, Cout], or [kh, kw, Cin, Cout] in 2-D), so only names
change, plus UNet3D's 1x1x1 head, which becomes an ``nn.Linear``. The 2-D
tree nests one scope deeper: a 2-D ``TorchConv`` keeps its kernel and bias
in a ``Conv_0`` child, which is how ``state_dict_from_flax`` tells the
two apart. ``adam_state_from_optax``
turns the JAX package's Adam state (``inject_hyperparams(optax.adam)``)
into a ``torch.optim.Adam`` state dict: mu -> exp_avg, nu -> exp_avg_sq,
count -> step. The two updates agree: torch's
lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps) is optax's
lr * m_hat / (sqrt(v_hat) + eps).

``read_flax_msgpack`` reads a JAX ``.ckpt`` (``checkpoint.save_checkpoint``
of the JAX package: flax msgpack of {params, batch_stats, opt_state, epoch})
with ``msgpack`` alone, and ``convert_checkpoint`` writes the port's
checkpoint from it, with the Adam state when the file has one, so that
``load_mode=1`` in the port resumes a JAX run::

    python -m general_medical_image_segmentation_cnn_framework_tpu_torch.convert \\
        latest_checkpoint.ckpt unet3d.pt
"""

from __future__ import annotations

import argparse
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


def convblock_state_dict_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """One Flax ``ConvBlock`` scope -> the port ConvBlock's state_dict; its
    parameters alone when ``batch_stats`` is None. The conv's kernel and
    bias sit in ``TorchConv_0`` (3-D) or in its ``Conv_0`` child (2-D)."""
    conv, bn = params["TorchConv_0"], params["BatchNorm_0"]
    conv = conv.get("Conv_0", conv)
    sd = {
        "conv.weight": _t(conv["kernel"]),
        "conv.bias": _t(conv["bias"]),
        "bn.weight": _t(bn["scale"]),
        "bn.bias": _t(bn["bias"]),
    }
    if batch_stats is not None:
        sd["bn.running_mean"] = _t(batch_stats["BatchNorm_0"]["mean"])
        sd["bn.running_var"] = _t(batch_stats["BatchNorm_0"]["var"])
    return sd


def unet3d_state_dict_from_flax(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """Flax UNet3D ``params``/``batch_stats`` (numpy leaves) -> port
    state_dict. Without ``batch_stats``: the parameters alone, for any tree
    shaped like ``params`` (its gradients, or Adam's mu or nu)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(N_BLOCKS):
        stats = None if batch_stats is None else batch_stats[f"ConvBlock_{i}"]
        block = convblock_state_dict_from_flax(params[f"ConvBlock_{i}"], stats)
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


def unet2d_state_dict_from_flax(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """Flax UNet2D ``params``/``batch_stats`` (numpy leaves) -> port
    state_dict: ``ConvBlock_i`` -> ``blocks.i``, the 1x1 head
    ``TorchConv_0/Conv_0`` -> ``head`` (kernel [1, 1, 64, classes] as it
    is). Without ``batch_stats``: the parameters alone, for any tree shaped
    like ``params``."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(N_BLOCKS):
        stats = None if batch_stats is None else batch_stats[f"ConvBlock_{i}"]
        block = convblock_state_dict_from_flax(params[f"ConvBlock_{i}"], stats)
        sd.update({f"blocks.{i}.{k}": v for k, v in block.items()})
    head = params["TorchConv_0"]["Conv_0"]
    sd["head.weight"] = _t(head["kernel"])
    sd["head.bias"] = _t(head["bias"])
    return sd


def state_dict_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """A Flax UNet3D or UNet2D tree -> the port's state_dict; the tree says
    which: a 2-D ``TorchConv`` keeps its kernel in a ``Conv_0`` child."""
    if "Conv_0" in params["ConvBlock_0"]["TorchConv_0"]:
        return unet2d_state_dict_from_flax(params, batch_stats)
    return unet3d_state_dict_from_flax(params, batch_stats)


def _model_of(sd: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """A port model with the shapes of ``sd`` (for Adam's parameter order)."""
    stem = sd["blocks.0.conv.weight"]
    if stem.ndim == 4:  # [3, 3, Cin, Cout]: UNet2D
        from .models.two_d.unet2d import UNet2D

        return UNet2D(stem.shape[2], sd["head.weight"].shape[-1])
    from .models.three_d.unet3d import UNet3D

    return UNet3D(stem.shape[3], sd["head.weight"].shape[0], stem.shape[4])


def adam_state_from_optax(opt_state: Mapping, model: torch.nn.Module) -> Dict:
    """The JAX package's ``inject_hyperparams(optax.adam)`` state (as
    ``flax.serialization.to_state_dict`` stores it) -> the state dict of a
    ``torch.optim.Adam`` over ``model.parameters()``."""
    inner, hyper = opt_state["inner_state"]["0"], opt_state["hyperparams"]
    mu, nu = state_dict_from_flax(inner["mu"]), state_dict_from_flax(inner["nu"])
    names = [name for name, _ in model.named_parameters()]
    template = torch.optim.Adam(model.parameters()).state_dict()
    step = float(np.asarray(inner["count"]))
    group = dict(template["param_groups"][0])
    group.update(
        lr=float(np.asarray(hyper["learning_rate"])),
        betas=(float(np.asarray(hyper["b1"])), float(np.asarray(hyper["b2"]))),
        eps=float(np.asarray(hyper["eps"])),
    )
    state = {
        i: {"step": torch.tensor(step), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, name in enumerate(names)
    }
    return {"state": state, "param_groups": [group]}


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
    """JAX UNet3D or UNet2D ``.ckpt`` -> the port's checkpoint at ``dst``,
    with the Adam state when ``src`` has one (else weights only)."""
    state = read_flax_msgpack(src)
    sd = state_dict_from_flax(state["params"], state["batch_stats"])
    opt_state = optimizer = None
    if state.get("opt_state"):
        model = _model_of(sd)
        opt_state, optimizer = adam_state_from_optax(state["opt_state"], model), "adam"
    save_checkpoint(dst, sd, int(state.get("epoch", 0)), opt_state, optimizer)


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m general_medical_image_segmentation_cnn_framework_tpu_torch.convert",
        description="JAX checkpoint (.ckpt) -> the PyTorch port's checkpoint (.pt)",
    )
    parser.add_argument("src")
    parser.add_argument("dst")
    args = parser.parse_args(argv)
    convert_checkpoint(args.src, args.dst)


if __name__ == "__main__":
    main()
