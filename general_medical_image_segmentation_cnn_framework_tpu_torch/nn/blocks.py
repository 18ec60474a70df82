"""The building blocks of the port's networks, channels-last (NDHWC / NHWC).

Parameters are float32 and keep the JAX package's layouts, so converted
checkpoints need no transposes: conv kernels are [kd, kh, kw, Cin, Cout]
in 3-D and [kh, kw, Cin, Cout] in 2-D (a block's spatial rank is its
weight's rank less two), Dense kernels [in, out].
Each block computes in its ``dtype`` (float32 or bfloat16) by casting its
input and weights explicitly, as the JAX blocks do; BatchNorm folding and
biases stay float32. Kernels are initialised by ``config.init_type``
(``nn.init``) from the ``torch.Generator`` the model passes in.

``ScopeNames`` records on each module the name of its variables' scope in
the JAX package's Flax tree (``{Class}_{i}``, counted per class in call
order), which is how ``convert.py`` carries any network's weights across;
each model's ``from_flax`` reads its widths from such a tree through
``flax_conv_io``.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv3d_bn_relu import conv2d_bn_relu, conv2d_k3s1, conv3d_bn_relu, conv3d_k3s1, fold_batchnorm
from .init import bias_initializer, kernel_initializer, lecun_normal
from .norm import BatchNorm, InstanceNorm


# ConvBlock.remat: None (no remat), or what the backward recomputes
REMAT_POLICIES = (None, "full", "conv", "dots")


def remat_policy(name: Optional[str]) -> str:
    """``config.remat_policy`` -> ``ConvBlock.remat``: '' and 'full'
    recompute the whole block, 'conv' and 'dots' keep the conv's output;
    anything else raises ``ValueError`` as the JAX package does."""
    if not name or name == "full":
        return "full"
    if name in ("conv", "dots"):
        return name
    raise ValueError(f"unknown remat_policy {name!r}")


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


IntOrTuple = Union[int, Sequence[int]]


def _to_tuple(v: IntOrTuple, n: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(i) for i in v)
    if len(t) != n:
        raise ValueError(f"expected an int or a length-{n} tuple, got {t}")
    return t


class ScopeNames:
    """Names the JAX package's Flax modules give the children they create:
    ``{Class}_{i}``, counted per class in the order of creation. Calling it
    on a module sets ``module.scope`` to the next name of the module's class
    (the port names its classes as the JAX package does) and returns the
    module."""

    def __init__(self):
        self._count = Counter()

    def __call__(self, module: nn.Module) -> nn.Module:
        cls = type(module).__name__
        module.scope = f"{cls}_{self._count[cls]}"
        self._count[cls] += 1
        return module


def flax_conv_io(params, *path: str) -> Tuple[int, int]:
    """(Cin, Cout) of the conv kernel in the Flax scope ``path`` of a params
    tree (its ``Conv_0`` child on XLA's conv route): what each model's
    ``from_flax`` reads its widths from."""
    for key in path:
        params = params[key]
    shape = params.get("Conv_0", params)["kernel"].shape
    return int(shape[-2]), int(shape[-1])


class TorchConv(nn.Module):
    """Conv over ``ndim`` spatial axes (3 or 2) with torch's integer
    padding, stride and dilation; ``weight`` is [k.., Cin, Cout], ``bias``
    [Cout] or None (``use_bias=False``, as Flax leaves the parameter out).
    ``padding=None`` is ``kernel_size // 2``.

    The k3 s1 p1 d1 conv runs the hand-written kernels: in train mode
    ``conv3d_k3s1`` / ``conv2d_k3s1`` (forward, input gradient and weight
    gradient), in eval mode the eval conv ``conv3d_bn_relu`` /
    ``conv2d_bn_relu`` with relu=False (the registered operator under
    ``torch.export``); on the CPU their plain versions. A pointwise conv
    (k1 s1 p0) is one matmul over the channels. Every other conv, which the
    JAX package runs through XLA's convolution and no Pallas kernel, is
    ``F.conv3d`` / ``F.conv2d``.

    With ``groups`` g (Flax's ``feature_group_count``), ``weight`` is
    [k.., Cin / g, Cout] and input channels i * Cin/g ... feed output
    channels i * Cout/g ...: always ``F.conv3d`` / ``F.conv2d`` with
    ``groups``, a grouped 1x1 or k3 conv included (MiniSeg's grouped and
    depthwise convs; XLA's conv in the JAX package)."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
        init_type: str = "none", generator: Optional[torch.Generator] = None,
        ndim: int = 3, kernel_size: IntOrTuple = 3, stride: IntOrTuple = 1,
        padding: Optional[IntOrTuple] = None, dilation: IntOrTuple = 1, use_bias: bool = True,
        groups: int = 1,
    ):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"TorchConv: ndim must be 2 or 3, got {ndim}")
        if cin % groups or cout % groups:
            raise ValueError(f"TorchConv: groups={groups} must divide Cin={cin} and Cout={cout}")
        self.dtype, self.ndim, self.groups = dtype, ndim, groups
        self.kernel_size = _to_tuple(kernel_size, ndim)
        self.stride = _to_tuple(stride, ndim)
        self.padding = tuple(k // 2 for k in self.kernel_size) if padding is None else _to_tuple(padding, ndim)
        self.dilation = _to_tuple(dilation, ndim)
        gen = _generator(generator)
        self.weight = nn.Parameter(kernel_initializer(init_type)(self.kernel_size + (cin // groups, cout), gen))
        if use_bias:
            self.bias = nn.Parameter(bias_initializer(init_type)((cout,), gen))
        else:
            self.register_parameter("bias", None)
        one = (1,) * ndim
        dense = groups == 1
        self.hand_kernel = dense and (self.kernel_size, self.stride, self.padding, self.dilation) == (
            (3,) * ndim, one, one, one)
        self.pointwise = dense and (self.kernel_size, self.stride, self.padding) == (one, one, (0,) * ndim)

    def _bias(self, device: torch.device) -> torch.Tensor:
        return self.bias if self.bias is not None else torch.zeros(self.weight.shape[-1], device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.hand_kernel:
            if not self.training:
                conv = conv3d_bn_relu if self.ndim == 3 else conv2d_bn_relu
                w = self.weight.to(self.dtype).contiguous()
                return conv(x.contiguous(), w, self._bias(x.device).float().contiguous(), relu=False)
            conv = conv3d_k3s1 if self.ndim == 3 else conv2d_k3s1
            return conv(x.contiguous(), self.weight, self._bias(x.device))
        if self.pointwise:
            y = x @ self.weight.reshape(self.weight.shape[-2:]).to(self.dtype)
            return y if self.bias is None else y + self.bias.to(self.dtype)
        conv = F.conv3d if self.ndim == 3 else F.conv2d
        nd = self.ndim
        w = self.weight.permute(nd + 1, nd, *range(nd)).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = conv(x.movedim(-1, 1), w, b, self.stride, self.padding, self.dilation, self.groups)
        return y.movedim(1, -1)


def _act(name: str):
    """The JAX package's ``ConvBlock`` activations by name (prelu is a module)."""
    acts = {
        "relu": torch.relu,
        "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
        "elu": F.elu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu is the tanh form
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "none": lambda x: x,
    }
    if name not in acts:
        raise ValueError(f"unknown activation {name!r}")
    return acts[name]


class ConvBlock(nn.Module):
    """Conv -> Norm -> Activation over ``ndim`` spatial axes, the JAX
    package's ``ConvBlock``: by default Conv(k3, p1) -> BatchNorm -> ReLU, the
    block of UNet3D (3) and of UNet2D (2); ``kernel_size`` / ``stride`` /
    ``padding`` / ``dilation`` / ``use_bias`` go to its ``TorchConv``,
    ``norm`` is batch | instance | none, ``act`` one of the JAX package's
    (relu, leaky_relu, elu, gelu, sigmoid, tanh, none, prelu).

    In eval mode the default block (k3 s1 p1 d1, batch, relu) folds
    BatchNorm into the conv (in f32) and is one ``conv3d_bn_relu`` or
    ``conv2d_bn_relu`` call: the CUDA kernel on a card, its plain version on
    the CPU, and under ``torch.export`` the registered operator that runs
    them; any other block runs its conv, norm and activation in turn. Train
    mode runs ``TorchConv`` (the kernels with their gradients), then the
    train-mode norm and the activation with autograd.

    ``remat`` (``remat_policy``: None, "full", "conv" or "dots") recomputes
    part of the train-mode block in the backward instead of keeping its
    activations (``torch.utils.checkpoint``): "full" keeps only the block's
    input and runs the conv kernel again; "conv" keeps the conv's output and
    recomputes the norm and activation. "dots" keeps what the JAX policy
    ``checkpoint_dots`` keeps of this block, the convolution's product: the
    conv kernel adds the bias in its epilogue, so that is "conv" here. The
    conv is a ctypes kernel inside an ``autograd.Function``, out of sight of
    a selective-checkpoint policy, so "conv" splits the block at the conv's
    output instead. BatchNorm's running statistics move once, outside the
    recomputed part."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
        init_type: str = "none", generator: Optional[torch.Generator] = None, ndim: int = 3,
        remat: Optional[str] = None, kernel_size: IntOrTuple = 3, stride: IntOrTuple = 1,
        padding: IntOrTuple = 1, dilation: IntOrTuple = 1, norm: str = "batch", act: str = "relu",
        use_bias: bool = True,
    ):
        super().__init__()
        if remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat!r}")
        if norm not in ("batch", "instance", "none"):
            raise ValueError(f"unknown norm {norm}")
        self.dtype, self.remat, self.norm, self.act = dtype, remat, norm, act
        self.conv = TorchConv(cin, cout, dtype, init_type, generator, ndim, kernel_size, stride, padding,
                              dilation, use_bias)
        self.conv.scope = "TorchConv_0"
        if norm == "batch":
            self.bn = BatchNorm(cout)
            self.bn.scope = "BatchNorm_0"
        elif norm == "instance":
            self.inorm = InstanceNorm(dtype=dtype)
        if act == "prelu":
            self.prelu = PReLU()
            self.prelu.scope = "PReLU_0"
        else:
            self._act_fn = _act(act)
        self.folds = self.conv.hand_kernel and norm == "batch" and act == "relu"

    def _norm_act(self, y: torch.Tensor):
        """(activation(norm(y)), BatchNorm's batch (mean, var) or None), train mode."""
        stats = None
        if self.norm == "batch":
            y, mean, var = self.bn.train_forward(y)
            stats = (mean, var)
        elif self.norm == "instance":
            y = self.inorm(y)
        return self._activation(y), stats

    def _activation(self, y: torch.Tensor) -> torch.Tensor:
        return self.prelu(y) if self.act == "prelu" else self._act_fn(y)

    def _block(self, x: torch.Tensor):
        return self._norm_act(self.conv(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if self.remat == "full":
                y, stats = checkpoint(self._block, x, use_reentrant=False, preserve_rng_state=False)
            elif self.remat is not None:  # the conv's output is kept
                y, stats = checkpoint(self._norm_act, self.conv(x), use_reentrant=False, preserve_rng_state=False)
            else:
                y, stats = self._block(x)
            if stats is not None:
                self.bn.update_running(*stats, y.numel() // y.shape[-1])
            return y
        if not self.folds:
            y = self.conv(x)
            if self.norm == "batch":
                y = self.bn(y)
            elif self.norm == "instance":
                y = self.inorm(y)
            return self._activation(y)
        w, b = fold_batchnorm(
            self.conv.weight, self.conv.bias, self.bn.weight, self.bn.bias,
            self.bn.running_mean, self.bn.running_var, self.bn.eps,
        )
        conv = conv3d_bn_relu if w.dim() == 5 else conv2d_bn_relu
        return conv(x.to(self.dtype).contiguous(), w.to(self.dtype), b)


class TorchConvTranspose(nn.Module):
    """ConvTranspose over ``ndim`` spatial axes (3 or 2) with torch's output
    size, (in - 1) * stride - 2 * padding + kernel, as the JAX package's
    ``TorchConvTranspose``. ``weight`` is [k.., Cin, Cout / groups] in the
    JAX convention, which applies the kernel spatially flipped: torch's
    ConvTranspose weight [Cin, Cout / groups, k..] is ``weight`` flipped
    over its spatial axes and permuted. ``stride`` defaults to the kernel.

    With ``groups`` g, input channels i * Cin/g ... and output channels
    i * Cout/g ... form group i: the JAX package's ``_GroupedConvTranspose``
    (SkipDenseNet3D's heads), one ``TorchConvTranspose`` a group, whose
    [k.., Cin/g, Cout/g] kernels ``weight`` holds concatenated along Cin,
    each drawn as its own kernel.

    Kernel = stride with no padding, ungrouped, in 3-D (the U-Nets' k2 s2
    up-convs, CSR-Net's k4 s4) is one matmul and a pixel shuffle, as the
    JAX package's ``conv_transpose_matmul``; every other one is
    ``F.conv_transpose3d`` / ``F.conv_transpose2d`` (XLA's transposed conv,
    or its phased form, in the JAX package)."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
        init_type: str = "none", generator: Optional[torch.Generator] = None, kernel_size: IntOrTuple = 2,
        stride: Optional[IntOrTuple] = None, padding: IntOrTuple = 0, groups: int = 1, use_bias: bool = True,
        ndim: int = 3,
    ):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"TorchConvTranspose: ndim must be 2 or 3, got {ndim}")
        if cin % groups or cout % groups:
            raise ValueError(f"TorchConvTranspose: groups={groups} must divide Cin={cin} and Cout={cout}")
        self.dtype, self.ndim, self.groups = dtype, ndim, groups
        self.kernel_size = _to_tuple(kernel_size, ndim)
        self.stride = self.kernel_size if stride is None else _to_tuple(stride, ndim)
        self.padding = _to_tuple(padding, ndim)
        gen = _generator(generator)
        init = kernel_initializer(init_type)
        shape = self.kernel_size + (cin // groups, cout // groups)
        self.weight = nn.Parameter(torch.cat([init(shape, gen) for _ in range(groups)], dim=-2))
        if use_bias:
            self.bias = nn.Parameter(bias_initializer(init_type)((cout,), gen))
        else:
            self.register_parameter("bias", None)
        self.matmul = (ndim == 3 and groups == 1 and self.kernel_size == self.stride and not any(self.padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        nd = self.ndim
        bias = None if self.bias is None else self.bias.to(self.dtype)
        if self.matmul:
            n, d, h, w, cin = x.shape
            (k, _, _), cout = self.kernel_size, self.weight.shape[-1]
            kern = self.weight.flip((0, 1, 2)).permute(3, 0, 1, 2, 4).reshape(cin, k**3 * cout)
            y = x.reshape(-1, cin) @ kern.to(self.dtype)
            y = y.reshape(n, d, h, w, k, k, k, cout).permute(0, 1, 4, 2, 5, 3, 6, 7)
            y = y.reshape(n, k * d, k * h, k * w, cout)
            return y if bias is None else y + bias
        w = self.weight.flip(tuple(range(nd))).permute(nd, nd + 1, *range(nd)).to(self.dtype)
        conv = F.conv_transpose3d if nd == 3 else F.conv_transpose2d
        return conv(x.movedim(-1, 1), w, bias, self.stride, self.padding, groups=self.groups).movedim(1, -1)


class PReLU(nn.Module):
    """torch ``nn.PReLU(num_parameters, init=0.25)`` on channels-last x:
    one ``alpha`` or one per channel (the last axis)."""

    def __init__(self, num_parameters: int = 1):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((num_parameters,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class Dense(nn.Module):
    """Flax ``nn.Dense``: ``x @ weight (+ bias)`` in ``dtype``, ``weight``
    [in, out] drawn LeCun-normal (Flax's default), ``bias`` zero."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None, use_bias: bool = True,
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(lecun_normal((cin, cout), _generator(generator)))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(cout))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.weight.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Dropout(nn.Module):
    """Dropout in train mode, inert in eval: each element is kept with
    probability 1 - p and scaled by 1 / (1 - p), as Flax's ``nn.Dropout``.
    ``broadcast_dims`` share one draw along those axes (1, 2, 3 of NDHWC: a
    channel is dropped whole, torch's ``Dropout3d``). The draws come from a
    generator of this module on x's device, seeded from ``generator``."""

    def __init__(self, p: float = 0.5, broadcast_dims: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.broadcast_dims = float(p), tuple(broadcast_dims)
        self.seed = int(torch.randint(0, 2**62, (1,), generator=_generator(generator)))
        self._generators = {}

    def generator_on(self, device: torch.device) -> torch.Generator:
        """This module's generator on ``device`` (a tensor's device, with its index),
        made at first use; a CUDA graph that replays the module registers it."""
        if device not in self._generators:
            self._generators[device] = torch.Generator(device=device).manual_seed(self.seed)
        return self._generators[device]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        shape = [1 if i in self.broadcast_dims else s for i, s in enumerate(x.shape)]
        keep = torch.rand(shape, generator=self.generator_on(x.device), device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


def max_pool(x: torch.Tensor, window: IntOrTuple = 2, stride: Optional[IntOrTuple] = None,
             padding: IntOrTuple = 0) -> torch.Tensor:
    """torch ``MaxPool3d`` / ``MaxPool2d`` on NDHWC / NHWC (by x's rank):
    floor output size, padding with -inf; ``stride`` defaults to the
    window. The JAX package's ``max_pool`` is XLA's window max, whose
    gradient goes wholly to the first maximum of a window in scan order;
    torch's max pool gives it to the same one (an ``amax`` over the windows
    would split a tie, which bf16 activations often hold)."""
    nd = x.dim() - 2
    w = _to_tuple(window, nd)
    s = w if stride is None else _to_tuple(stride, nd)
    pool = F.max_pool3d if nd == 3 else F.max_pool2d
    return pool(x.movedim(-1, 1), w, s, _to_tuple(padding, nd)).movedim(1, -1)


def avg_pool(x: torch.Tensor, window: IntOrTuple = 2, stride: Optional[IntOrTuple] = None,
             padding: IntOrTuple = 0) -> torch.Tensor:
    """torch ``AvgPool3d`` / ``AvgPool2d`` on NDHWC / NHWC (by x's rank),
    floor output size, ``stride`` defaulting to the window: the JAX
    package's ``avg_pool`` (``flax.linen.avg_pool``). Both count a padded
    cell as a 0 in the window, so every window divides by its full size."""
    nd = x.dim() - 2
    w = _to_tuple(window, nd)
    s = w if stride is None else _to_tuple(stride, nd)
    pool = F.avg_pool3d if nd == 3 else F.avg_pool2d
    return pool(x.movedim(-1, 1), w, s, _to_tuple(padding, nd), count_include_pad=True).movedim(1, -1)


def adaptive_avg_pool2d(x: torch.Tensor, size: int) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d(size)`` on NHWC x: output cell i of an axis
    of length L averages cells floor(i L / size) to ceil((i + 1) L / size)
    (the segments overlap where size does not divide L, and where size > L),
    PSPNet's ``adaptive_avg_pool2d`` in the JAX package."""
    return F.adaptive_avg_pool2d(x.movedim(-1, 1), size).movedim(1, -1)


def max_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool3d(2, 2, ceil_mode=True)`` (``MaxPool2d`` on NHWC) on
    channels-last x, FCN3D's ``_ceil_pool`` in the JAX package: an odd axis
    keeps its last element in a window of one. JAX pads with -inf and runs
    XLA's window max, whose gradient goes wholly to the first maximum of a
    window in scan order; torch's max pool gives it to the same one (its
    ``amax`` would split a tie)."""
    pool = F.max_pool3d if x.dim() == 5 else F.max_pool2d
    return pool(x.movedim(-1, 1), 2, 2, ceil_mode=True).movedim(1, -1)


def max_pool_with_mask(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 stride-2 max pool of NHWC x and a one-hot window mask
    [B, H/2, W/2, 4, C] of each window's first maximum, SegNet's pooling
    with indices, as the JAX package's: the windows by reshape, their
    ``amax`` (a tie's gradient split evenly, as ``jnp.max``'s), and the
    equality mask kept at its first match by a cumulative sum."""
    b, h, w, c = x.shape
    windows = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4, c)
    pooled = windows.amax(dim=3)
    mask = (windows == pooled.unsqueeze(3)).to(x.dtype)
    return pooled, mask * (mask.cumsum(dim=3) == 1).to(x.dtype)


def max_unpool_with_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The inverse of ``max_pool_with_mask``: each value of NHWC x placed
    at its window's masked slot, zeros elsewhere ([B, 2H, 2W, C])."""
    b, h, w, c = x.shape
    windows = x.unsqueeze(3) * mask
    return windows.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes, kept as size-1 axes: [N, 1.., C]."""
    return x.mean(dim=tuple(range(1, x.dim() - 1)), keepdim=True)


def resize_nearest(x: torch.Tensor, scale: IntOrTuple = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling of the spatial axes by integer factors
    (torch ``Upsample(mode='nearest')``, the JAX ``jax.image.resize``
    'nearest' at an integer scale): each voxel repeated ``scale`` times."""
    n, *spatial, c = x.shape
    s = _to_tuple(scale, len(spatial))
    view = [n] + [v for size in spatial for v in (size, 1)] + [c]
    expand = [n] + [v for size, k in zip(spatial, s) for v in (size, k)] + [c]
    return x.reshape(view).expand(expand).reshape(n, *(size * k for size, k in zip(spatial, s)), c)


def resize_linear_align_corners(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """torch ``interpolate(mode='bilinear' / 'trilinear', align_corners=True)``
    of the spatial axes of NHWC / NDHWC x to ``shape``: output index j samples
    the input at j*(in-1)/(out-1) per axis, as the JAX package's function of
    the same name. In x's dtype (for bf16 PyTorch interpolates in f32 and
    rounds once; the JAX package lerps in bf16)."""
    mode = "bilinear" if x.dim() == 4 else "trilinear"
    y = F.interpolate(x.movedim(-1, 1), size=tuple(int(s) for s in shape), mode=mode, align_corners=True)
    return y.movedim(1, -1)


def resize_linear(x: torch.Tensor, scale: IntOrTuple = 2, shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Bi- / trilinear resize of the spatial axes of NHWC / NDHWC x by
    ``scale`` or to ``shape``, half-pixel centres (torch ``interpolate``
    with ``align_corners=False``): the JAX package's ``resize_linear``
    (``jax.image.resize`` 'linear' without antialiasing) wherever it
    upsamples."""
    spatial = x.shape[1:-1]
    if shape is None:
        shape = tuple(size * k for size, k in zip(spatial, _to_tuple(scale, len(spatial))))
    mode = "bilinear" if x.dim() == 4 else "trilinear"
    y = F.interpolate(x.movedim(-1, 1), size=tuple(int(s) for s in shape), mode=mode, align_corners=False)
    return y.movedim(1, -1)
