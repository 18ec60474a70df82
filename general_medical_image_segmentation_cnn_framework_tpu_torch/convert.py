"""Carry the JAX package's weights to the port, for every ported network.

``state_dict_from_flax`` maps a Flax variable tree (params and
batch_stats) onto the port model's ``state_dict``. The port keeps the Flax
layouts (conv kernels [kd, kh, kw, Cin, Cout], or [kh, kw, Cin, Cout] in
2-D, Dense kernels [in, out]), so only names change, and one walker
(``module_state_dict_from_flax``) maps every network module by module:
each port module that owns variables records the Flax scope they sit in
(``module.scope``, set by ``nn.blocks.ScopeNames``), and the leaves
(TorchConv, TorchConvTranspose, BatchNorm, InstanceNorm, LayerNorm, PReLU,
Dense and VT-UNet's matmul convs, and UNet3D's 1x1x1 head, an
``nn.Linear`` that takes the kernel transposed) read their Flax names, and
a module's own parameters (UNETR's ``position_embeddings``, the window
attention's ``relative_position_bias_table``) theirs. A module used twice (res_unet's shared convs, IS's
shared encoder) is one port module in one Flax scope: one set of weights;
SkipDenseNet3D's grouped transposed conv is one port module over the JAX
one's per-group scopes.
``network_of`` tells the network from the tree's top-level scopes (those
of the ported networks all differ); ``model_for_tree`` builds the port
model of the tree's widths by the class's ``from_flax``.

``optimizer_state_from_optax`` tells from the tree which optimizer the JAX
package's ``make_optimizer`` built (adam, adamw or sgd, with or without
``grad_clip``) and turns its state into the state dict of the port's
optimizer for the same config (``optim.make_optimizer``): Adam / AdamW's
mu -> exp_avg, nu -> exp_avg_sq, count -> step; SGD's trace ->
momentum_buffer (plain SGD has no state), each by the parameters' map. The
updates agree: torch's lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps) is
optax's lr * m_hat / (sqrt(v_hat) + eps), and torch's momentum buffer is
optax's trace.

``read_flax_msgpack`` reads a JAX ``.ckpt`` (``checkpoint.save_checkpoint``
of the JAX package: flax msgpack of {params, batch_stats, opt_state, epoch})
with ``msgpack`` alone, and ``convert_checkpoint`` writes the port's
checkpoint from it, with the optimizer's state and name when the file has
one, so that ``load_mode=1`` in the port resumes a JAX run; an orbax
checkpoint directory (``checkpoint_backend=orbax``) is refused::

    python -m general_medical_image_segmentation_cnn_framework_tpu_torch.convert \\
        latest_checkpoint.ckpt model.pt
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .checkpoint import save_checkpoint

# flax msgpack extension types (flax.serialization._MsgpackExtType)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _leaf_from_flax(module: torch.nn.Module, params: Mapping, stats: Optional[Mapping]) -> Dict[str, torch.Tensor]:
    """The tensors a leaf module owns, from its Flax scope: a conv's
    ``kernel`` and ``bias`` (directly, or in the ``Conv_0`` child of XLA's
    route), a grouped transposed conv's groups' kernels (its scope's
    ``TorchConvTranspose_{g}``) concatenated along Cin, a 1x1x1 conv's
    kernel [1, 1, 1, Cin, Cout] as an ``nn.Linear``'s [Cout, Cin] weight,
    BatchNorm's ``scale``/``bias`` and ``mean``/``var`` statistics, an
    affine InstanceNorm's and a LayerNorm's ``scale``/``bias``, PReLU's
    ``alpha``, Dense's (and VT-UNet's matmul conv's) ``kernel``/``bias``;
    the parameters a module names in ``flax_params`` (UNet++'s ``mix``,
    FCN32s's ``upscore_kernel``, UNETR's ``position_embeddings``, the
    window attention's ``relative_position_bias_table``) under their own
    names;
    nothing else. A grouped conv's kernel [k.., Cin / g, Cout] is read as
    any other."""
    from .nn.blocks import Dense, PReLU, TorchConv, TorchConvTranspose
    from .nn.norm import BatchNorm, InstanceNorm, LayerNorm

    sd = {name: _t(params[name]) for name in getattr(module, "flax_params", ())}
    if isinstance(module, TorchConvTranspose) and module.groups > 1:
        sd["weight"] = _t(np.concatenate(
            [np.asarray(params[f"TorchConvTranspose_{g}"]["kernel"], dtype=np.float32) for g in range(module.groups)],
            axis=-2))
    elif isinstance(module, (TorchConv, TorchConvTranspose, Dense)):
        p = params.get("Conv_0", params)
        sd["weight"] = _t(p["kernel"])
        if module.bias is not None:
            sd["bias"] = _t(p["bias"])
    elif isinstance(module, torch.nn.Linear):
        kernel = np.asarray(params["kernel"], dtype=np.float32)
        sd["weight"], sd["bias"] = _t(kernel.reshape(kernel.shape[-2:]).T), _t(params["bias"])
    elif isinstance(module, (BatchNorm, InstanceNorm, LayerNorm)):
        if module.weight is not None:
            sd["weight"], sd["bias"] = _t(params["scale"]), _t(params["bias"])
        if isinstance(module, BatchNorm) and stats is not None:
            sd["running_mean"], sd["running_var"] = _t(stats["mean"]), _t(stats["var"])
    elif isinstance(module, PReLU):
        sd["alpha"] = _t(params["alpha"])
    return sd


def module_state_dict_from_flax(
    module: torch.nn.Module, params: Mapping, batch_stats: Optional[Mapping] = None, path: str = ""
) -> Dict[str, torch.Tensor]:
    """``module``'s state_dict from the Flax scope ``params`` (and
    ``batch_stats``; without them the parameters alone, for any tree shaped
    like ``params``: gradients, Adam's mu or nu). A child with a ``scope``
    reads that child scope; a child without one (a ModuleList, a container)
    reads its parent's."""
    sd = _leaf_from_flax(module, params, batch_stats)
    for name, child in module.named_children():
        scope = getattr(child, "scope", None)
        sub_p, sub_s = params, batch_stats
        if scope is not None:
            if scope not in params:
                if any(True for _ in child.parameters()):
                    raise KeyError(f"the Flax tree has no scope {path + scope!r} for the port's {name} "
                                   f"({type(child).__name__}); found {sorted(params)}")
                continue
            sub_p = params[scope]
            sub_s = None if batch_stats is None else batch_stats.get(scope, {})
        sub = module_state_dict_from_flax(child, sub_p, sub_s, f"{path}{scope}/" if scope else path)
        sd.update({f"{name}.{k}": v for k, v in sub.items()})
    return sd


# network -> the top-level scope that tells it from the others, in the order they are tried
_SIGNATURES = (
    ("IS", "_Encoder_0"), ("dunet", "_UNet3Level_0"), ("fusionnet", "UNet3D_0"),
    ("highresnet", "DilationBlock_0"), ("vnet", "_NConvs_0"), ("res_unet", "_NormLReluConv_0"),
    ("er_net", "SFDecoder_0"), ("re_net", "ResEncoder_0"), ("densenet", "_GroupedConvTranspose_0"),
    ("densevoxelnet", "_DenseLayer_0"), ("fcn3d", "_BilinearDeconv_0"), ("unetpp", "_BasicBlock_0"),
    ("segnet", "ConvBlock_24"), ("fcn2d", "upscore_kernel"), ("deeplab", "ResNetBackbone_0"),
    ("pspnet", "_ResNet34Dilated_0"), ("miniseg", "_DilatedParallelConvBlockD2_0"),
    ("unetr", "_TransformerBlock_0"), ("vtnet", "SwinTransformerSys3D_0"),
)


def _conv_rank(params: Mapping, *path: str) -> int:
    """The rank of the conv kernel in the Flax scope ``path``: 5 in 3-D, 4 in 2-D."""
    for key in path:
        params = params[key]
    return len(params.get("Conv_0", params)["kernel"].shape)


def network_of(params: Mapping) -> str:
    """The port's ``config.network`` of a Flax params tree of the JAX
    package; ``ValueError`` naming the top-level scopes when it is none of
    the ported networks."""
    keys = set(params) if isinstance(params, Mapping) else set()
    for network, key in _SIGNATURES:
        if key in keys:
            if network == "highresnet" and _conv_rank(params, "ConvolutionalBlock_0", "TorchConv_0") == 4:
                return "highres2dnet"
            return network
    if "ConvBlock_17" in keys and isinstance(params["ConvBlock_0"], Mapping):
        if _conv_rank(params, "ConvBlock_0", "TorchConv_0") == 4:  # [3, 3, Cin, Cout]
            return "unet2d"
        if "Conv_0" in keys:
            return "unet"
        if "TorchConv_0" in keys and "TorchConvTranspose_6" in keys:
            return "csrnet"
    raise ValueError(f"a Flax tree of no network the port carries; its top-level scopes: {sorted(keys)}")


def model_for_tree(params: Mapping) -> torch.nn.Module:
    """A float32 port model of the network (``network_of``) and widths of
    the Flax params tree ``params``."""
    from .models.registry import model_class

    return model_class(network_of(params)).from_flax(params)


def state_dict_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """A Flax tree of any ported network -> the port's state_dict, by
    ``module_state_dict_from_flax`` over ``model_for_tree`` of the tree;
    without ``batch_stats``, the parameters alone (for a gradient tree or
    Adam's mu or nu)."""
    return module_state_dict_from_flax(model_for_tree(params), params, batch_stats)


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
        trace = module_state_dict_from_flax(model, inner["trace"]) if inner else None
        state = {i: {"momentum_buffer": trace[n]} for i, n in enumerate(order)} if trace else {}
    else:
        mu, nu = module_state_dict_from_flax(model, inner["mu"]), module_state_dict_from_flax(model, inner["nu"])
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
    """A JAX ``.ckpt`` of any ported network (told from its tree) -> the
    port's checkpoint at ``dst``, with the optimizer's state and name when
    ``src`` has one (else weights only)."""
    if Path(src).is_dir():
        raise ValueError(
            f"{src} is a directory: an orbax checkpoint (checkpoint_backend=orbax); the converter reads "
            "the flax msgpack .ckpt of checkpoint_backend=msgpack only"
        )
    state = read_flax_msgpack(src)
    model = model_for_tree(state["params"])
    sd = module_state_dict_from_flax(model, state["params"], state["batch_stats"])
    opt_state = optimizer = None
    if state.get("opt_state"):
        opt_state, optimizer = optimizer_state_from_optax(state["opt_state"], model)
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
