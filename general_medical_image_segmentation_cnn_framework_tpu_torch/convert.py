"""Carry UNet3D and UNet2D weights from the JAX package to the port.

``unet3d_state_dict_from_flax`` and ``unet2d_state_dict_from_flax`` map the
Flax variable tree (params and batch_stats) onto the port's
``state_dict``. The port keeps the Flax layouts (conv kernels
[kd, kh, kw, Cin, Cout], or [kh, kw, Cin, Cout] in 2-D), so only names
change, plus UNet3D's 1x1x1 head, which becomes an ``nn.Linear``. The 2-D
tree nests one scope deeper: a 2-D ``TorchConv`` keeps its kernel and bias
in a ``Conv_0`` child, which is how ``state_dict_from_flax`` tells the
two apart.

``optimizer_state_from_optax`` tells from the tree which optimizer the JAX
package's ``make_optimizer`` built (adam, adamw or sgd, with or without
``grad_clip``) and turns its state into the state dict of the port's
optimizer for the same config (``optim.make_optimizer``): Adam / AdamW's
mu -> exp_avg, nu -> exp_avg_sq, count -> step; SGD's trace ->
momentum_buffer (plain SGD has no state). The updates agree: torch's
lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps) is optax's
lr * m_hat / (sqrt(v_hat) + eps), and torch's momentum buffer is optax's
trace.

``read_flax_msgpack`` reads a JAX ``.ckpt`` (``checkpoint.save_checkpoint``
of the JAX package: flax msgpack of {params, batch_stats, opt_state, epoch})
with ``msgpack`` alone, and ``convert_checkpoint`` writes the port's
checkpoint from it, with the optimizer's state and name when the file has
one, so that ``load_mode=1`` in the port resumes a JAX run; an orbax
checkpoint directory (``checkpoint_backend=orbax``) is refused::

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
    """A port model with the shapes of ``sd`` (for the optimizer's parameter order)."""
    stem = sd["blocks.0.conv.weight"]
    if stem.ndim == 4:  # [3, 3, Cin, Cout]: UNet2D
        from .models.two_d.unet2d import UNet2D

        return UNet2D(stem.shape[2], sd["head.weight"].shape[-1])
    from .models.three_d.unet3d import UNet3D

    return UNet3D(stem.shape[3], sd["head.weight"].shape[0], stem.shape[4])


def _optax_kind(opt_state: Mapping):
    """(optimizer name, its optax state) of a ``make_optimizer`` state tree.

    ``inject_hyperparams`` keeps the optimizer's state in ``inner_state``:
    adam (``optax.adam``): {0: {count, mu, nu}, 1: {}}; adamw (adam + the
    masked decay + the lr scale): {0: {count, mu, nu}, 1: {inner_state: {}},
    2: {}}; sgd: {0: {trace} or {}, 1: {}}. ``grad_clip > 0`` chains
    clip_by_global_norm in front: {0: {}, 1: <that state>}."""
    inner = opt_state.get("inner_state") if isinstance(opt_state, Mapping) else None
    found = _describe(opt_state)
    if not isinstance(inner, Mapping):
        raise ValueError(f"not an optax state of the JAX make_optimizer (no inner_state): {found}")
    chain = inner
    if inner.get("0") == {} and isinstance(inner.get("1"), Mapping) and inner["1"] and all(k.isdigit() for k in inner["1"]):
        chain = inner["1"]  # the clip_by_global_norm wrapper
    first, keys = chain.get("0"), sorted(chain)
    if isinstance(first, Mapping) and {"count", "mu", "nu"} <= set(first):
        if keys == ["0", "1"] and chain["1"] == {}:
            return "adam", first
        if keys == ["0", "1", "2"] and chain["1"] == {"inner_state": {}} and chain["2"] == {}:
            return "adamw", first
    if keys == ["0", "1"] and chain["1"] == {} and (first == {} or (isinstance(first, Mapping) and set(first) == {"trace"})):
        return "sgd", first
    raise ValueError(f"an optax state the converter does not know (adam | adamw | sgd, with or without grad_clip): {found}")


def _describe(tree, depth: int = 0) -> str:
    """The keys of a state tree down to the optimizer's state, for errors."""
    if not isinstance(tree, Mapping):
        return type(tree).__name__
    if depth > 3:
        return "{...}"
    return "{" + ", ".join(f"{k}: {_describe(v, depth + 1)}" for k, v in tree.items()) + "}"


def optimizer_state_from_optax(opt_state: Mapping, model: torch.nn.Module):
    """(state dict of the port's optimizer over ``model.parameters()``,
    optimizer name) from the JAX package's optax state (as
    ``flax.serialization.to_state_dict`` stores it). The hyperparameters in
    the state dict are placeholders: resuming takes them from the config."""
    from .config import ConfigDict
    from .optim import make_optimizer

    name, inner = _optax_kind(opt_state)
    optimizer = make_optimizer(ConfigDict(optimizer=name, init_lr=1e-3, momentum=0.9 if inner else 0.0),
                               model.parameters())
    name_of = {id(p): n for n, p in model.named_parameters()}
    order = [name_of[id(p)] for group in optimizer.param_groups for p in group["params"]]
    template = optimizer.state_dict()
    if name == "sgd":
        trace = state_dict_from_flax(inner["trace"]) if inner else None
        state = {i: {"momentum_buffer": trace[n]} for i, n in enumerate(order)} if trace else {}
    else:
        mu, nu = state_dict_from_flax(inner["mu"]), state_dict_from_flax(inner["nu"])
        step = torch.tensor(float(np.asarray(inner["count"])))
        state = {i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]} for i, n in enumerate(order)}
    return {"state": state, "param_groups": template["param_groups"]}, name


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
    with the optimizer's state and name when ``src`` has one (else weights
    only)."""
    if Path(src).is_dir():
        raise ValueError(
            f"{src} is a directory: an orbax checkpoint (checkpoint_backend=orbax); the converter reads "
            "the flax msgpack .ckpt of checkpoint_backend=msgpack only"
        )
    state = read_flax_msgpack(src)
    sd = state_dict_from_flax(state["params"], state["batch_stats"])
    opt_state = optimizer = None
    if state.get("opt_state"):
        opt_state, optimizer = optimizer_state_from_optax(state["opt_state"], _model_of(sd))
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
