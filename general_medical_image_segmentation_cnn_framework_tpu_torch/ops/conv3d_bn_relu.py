"""Fused k3 s1 SAME Conv3d / Conv2d + folded BatchNorm + ReLU, channels-last.

The eval ConvBlock of UNet3D is one call of ``conv3d_bn_relu``: BatchNorm
is folded into the conv's weights and bias (``fold_batchnorm``), and the
conv, bias and ReLU run as one hand-written CUDA kernel
(``csrc/conv3d_bn_relu.cu``), which replaces the JAX package's Pallas
kernels ``ops/pallas_conv.fused_conv3d_bn_relu``,
``ops/pallas_tlayout.conv3d_tlayout`` (eval forward) and
``ops/pallas_tlayout.conv3d_tlayout_fused``.

For a CUDA tensor the wrapper launches the kernel, and a failed build or
launch raises. For a CPU tensor it computes ``conv3d_bn_relu_reference``,
the plain PyTorch version, which is also the kernel's oracle in the tests
and in ``chip_smoke.py``. Both eval convs are also registered PyTorch
operators, ``torch.ops.gmist_torch.conv3d_bn_relu`` and
``...conv2d_bn_relu`` (``torch.library.custom_op``; importing this module
registers them): while ``torch.export`` traces, the wrappers call them, so
that an exported graph (``serving.export_predictor``) records the hand
kernel's operator instead of tracing through it. Their kernels are the
same: the hand kernel, counted, for CUDA tensors; the plain version for
CPU tensors; a shape function for fake tensors.

The train-mode conv is ``conv3d_k3s1``, the counterpart of the JAX
package's ``ops/pallas_conv.pallas_conv3d`` (and of the custom VJP of
``ops/pallas_tlayout.conv3d_tlayout``): its forward is this kernel with
relu=False and the conv bias in the kernel's bias, its input gradient is
``conv3d_input_grad`` (this kernel again on the spatially flipped,
Cin<->Cout-transposed weights, with its own launch count), and its weight
gradient is ``ops.conv3d_wgrad``.

The 2-D counterparts, on NHWC tensors with [3, 3, Cin, Cout] weights, are
``conv2d_bn_relu``, ``conv2d_input_grad`` and ``conv2d_k3s1``, each with
its own launch count. They run the same kernel with one depth tap
(KD = 1) on the input taken as NDHWC with D = 1, and replace the JAX
package's Pallas kernel ``ops/pallas_tlayout.conv2d_plane_tlayout`` (the
2-D zoo's conv and, through its custom VJP, that conv's input gradient);
their weight gradient is ``ops.conv3d_wgrad.conv2d_wgrad``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .conv3d_wgrad import conv2d_wgrad, conv3d_wgrad

_DTYPES = (torch.float32, torch.bfloat16)
_BM = 128  # output voxels per block of the bf16 wgmma kernel
_BK = 64  # K per pipeline stage of that kernel; K chunks are multiples of it
_TARGET_BLOCKS = 264  # two waves of one block per SM of an H100 (132 SMs)
_MIN_K = 256  # K a split sums at least


def tile_n(cout: int) -> int:
    """Output channels per block of the bf16 wgmma kernel for this Cout."""
    return 32 if cout <= 32 else 64 if cout <= 64 else 128 if cout <= 128 else 256


def conv_split_k(voxels: int, k: int, cout: int):
    """(kchunk, splits) of the bf16 wgmma conv: the reduction K = taps * Cin
    is cut into ``splits`` ranges of ``kchunk`` (a multiple of the kernel's
    K step) where the output tiles alone fill less than _TARGET_BLOCKS
    blocks (the deep 4^3-16^2 grids), so that tiles x splits fill the card.
    Each split writes an f32 partial and a second pass sums them in split
    order, then adds the bias and the ReLU. Depends on the shapes only."""
    tiles = -(-voxels // _BM) * -(-cout // tile_n(cout))
    splits = max(1, min(_TARGET_BLOCKS // tiles, k // _MIN_K))
    kchunk = -(-(-(-k // splits)) // _BK) * _BK
    return kchunk, -(-k // kchunk)


def fold_batchnorm(
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into a conv, in f32:
    scale*(conv(x; k)+b - mean)/sqrt(var+eps) + beta = conv(x; k*g) + (b-mean)*g + beta
    with g = scale/sqrt(var+eps) broadcast over Cout, the last axis of ``kernel``."""
    g = bn_scale.float() / torch.sqrt(bn_var.float() + eps)
    b = bias.float() if bias is not None else 0.0
    return kernel.float() * g, (b - bn_mean.float()) * g + bn_bias.float()


def _reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """``F.conv3d`` or ``F.conv2d`` (by x's rank) + bias (+ ReLU) in f32 (f64
    for f64 x) on channels-last x and [3, .., 3, Cin, Cout] w, cast to x's
    dtype."""
    nd = x.dim() - 2
    conv = F.conv3d if nd == 3 else F.conv2d
    dt = torch.promote_types(x.dtype, torch.float32)
    y = conv(x.to(dt).movedim(-1, 1), w.to(dt).permute(nd + 1, nd, *range(nd)), b.to(dt), padding=1)
    if relu:
        y = F.relu(y)
    return y.movedim(1, -1).to(x.dtype).contiguous()


def conv3d_bn_relu_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv3d`` + bias (+ ReLU) in f32, cast to
    x's dtype. x [N,D,H,W,Cin], w [3,3,3,Cin,Cout], b [Cout] -> [N,D,H,W,Cout]."""
    return _reference(x, w, b, relu)


def conv2d_bn_relu_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of ``conv2d_bn_relu``: ``F.conv2d`` + bias
    (+ ReLU) in f32, cast to x's dtype. x [N,H,W,Cin], w [3,3,Cin,Cout],
    b [Cout] -> [N,H,W,Cout]."""
    return _reference(x, w, b, relu)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, nd: int) -> None:
    name = f"conv{nd}d_bn_relu"
    if x.dtype not in _DTYPES and not (x.dtype == torch.float64 and x.device.type == "cpu"):
        raise TypeError(f"{name}: x must be float32 or bfloat16 (or float64 on the CPU), got {x.dtype}")
    if x.dim() != nd + 2 or x.numel() == 0:
        layout = "[N,D,H,W,Cin]" if nd == 3 else "[N,H,W,Cin]"
        raise ValueError(f"{name}: x must be a non-empty {layout}, got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != nd + 2 or tuple(w.shape[:-1]) != (3,) * nd + (cin,):
        raise ValueError(f"{name}: w must be [{'3,' * nd}{cin},Cout], got {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: w must have x's dtype {x.dtype}, got {w.dtype}")
    if tuple(b.shape) != (w.shape[-1],) or b.dtype != torch.float32:
        raise ValueError(f"{name}: b must be float32 [{w.shape[-1]}], got {b.dtype} {tuple(b.shape)}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: x, w and b must be contiguous")
    if not (x.device == w.device == b.device):
        raise ValueError(f"{name}: x, w and b must share a device, got {x.device}, {w.device}, {b.device}")


@functools.cache
def _kernel():
    lib = _build.load("conv3d_bn_relu")
    fn = lib.conv3d_bn_relu_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _tiled(x: torch.Tensor, w: torch.Tensor, cout: int) -> bool:
    """Whether the kernel takes its wgmma variant for x and w (y, allocated
    by the wrapper, is aligned): bf16, Cin and Cout multiples of 8, 16-byte
    aligned pointers. Only that variant splits K and reads flipped weights."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0 and cout % 8 == 0
            and (x.data_ptr() | w.data_ptr()) % 16 == 0)


def _launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], relu: bool, flip: bool = False) -> torch.Tensor:
    """The kernel on x [N,D,H,W,Cin] (KD = 3) or x [N,H,W,Cin] (KD = 1,
    launched as D = 1); y has x's rank. With ``flip``, w is the forward
    conv's weight [3,..,3,Cout,Cin] of the conv whose input gradient this
    is, read flipped and transposed by the kernel, and b may be None."""
    nd = x.dim() - 2
    if x.device.type != "cuda":
        raise ValueError(f"conv{nd}d_bn_relu: unsupported device {x.device}")
    n, *spatial, cin = x.shape
    d, h, wd = spatial if nd == 3 else (1, *spatial)
    cout = w.shape[-2] if flip else w.shape[-1]
    k = (3 if nd == 3 else 1) * 9 * cin
    y = torch.empty((n, *spatial, cout), dtype=x.dtype, device=x.device)
    tiled = _tiled(x, w, cout)
    kchunk, splits = conv_split_k(n * d * h * wd, k, cout) if tiled else (-(-k // _BK) * _BK, 1)
    part = (torch.empty((splits, n * d * h * wd, cout), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    err = _kernel()(
        x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None, y.data_ptr(),
        part.data_ptr() if part is not None else None,
        n, d, h, wd, cin, cout, 3 if nd == 3 else 1, int(relu), int(flip), int(x.dtype == torch.bfloat16),
        kchunk, splits,
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv{nd}d_bn_relu: CUDA launch failed with cudaError {err}")
    return y


NAMESPACE = "gmist_torch"  # of the registered operators: torch.ops.gmist_torch.*


def _launch_counted(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """The kernel on CUDA tensors, one more on the launch count of the
    wrapper of x's rank."""
    y = _launch(x, w, b, relu)
    _build.count_launch(conv3d_bn_relu if x.dim() == 5 else conv2d_bn_relu)
    return y


def _register(nd: int, reference):
    """The registered eval conv of spatial rank ``nd``: its CUDA kernel
    launches the hand kernel and counts the launch; its CPU kernel is
    ``reference``; its fake kernel gives [N, ..., Cout] in x's dtype.
    Other devices have no kernel and raise."""
    op = torch.library.custom_op(
        f"{NAMESPACE}::conv{nd}d_bn_relu", _launch_counted, mutates_args=(), device_types="cuda",
    )
    op.register_kernel("cpu")(reference)

    @op.register_fake
    def _(x, w, b, relu):
        return x.new_empty((*x.shape[:-1], w.shape[-1]))

    return op


_REGISTERED = {3: _register(3, conv3d_bn_relu_reference), 2: _register(2, conv2d_bn_relu_reference)}


def _eval_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool, nd: int) -> torch.Tensor:
    """The conv of rank ``nd``: through its registered operator while
    ``torch.export`` traces, else called directly, as the operator's
    kernels would be (the operator's dispatch costs the host about 30 us
    more a call, and UNet2D's predict, 864 convs a volume, is bound by the
    host: ``chip_smoke.py`` [14], ``PERF.md`` section 6)."""
    _check(x, w, b, nd)
    if torch.compiler.is_exporting():
        return _REGISTERED[nd](x, w, b, relu)
    if x.device.type == "cpu":
        return _reference(x, w, b, relu)
    return _launch_counted(x, w, b, relu)


def conv3d_bn_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """y = [relu](conv3d_k3s1_same(x, w) + b), NDHWC in x's dtype.

    x [N,D,H,W,Cin] float32 or bfloat16 (or float64 on the CPU); w [3,3,3,Cin,Cout] in x's dtype
    (BN folded in); b float32 [Cout]. A CUDA tensor runs the CUDA kernel and
    adds one to ``conv3d_bn_relu.launches``; a CPU tensor runs
    ``conv3d_bn_relu_reference``; under ``torch.export`` the graph records
    the operator ``torch.ops.gmist_torch.conv3d_bn_relu``, which does the
    same when the graph runs."""
    return _eval_conv(x, w, b, relu, 3)


conv3d_bn_relu.launches = 0


def conv2d_bn_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """y = [relu](conv2d_k3s1_same(x, w) + b), NHWC in x's dtype.

    x [N,H,W,Cin] float32 or bfloat16; w [3,3,Cin,Cout] in x's dtype (BN
    folded in); b float32 [Cout]. A CUDA tensor runs the kernel with one
    depth tap and adds one to ``conv2d_bn_relu.launches``; a CPU tensor runs
    ``conv2d_bn_relu_reference``; under ``torch.export`` the graph records
    the operator ``torch.ops.gmist_torch.conv2d_bn_relu``."""
    return _eval_conv(x, w, b, relu, 2)


conv2d_bn_relu.launches = 0


def _flip_transpose(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weights and zero bias that turn the forward conv into its input
    gradient: k3 s1 SAME correlation is self-adjoint up to this relabelling
    (all spatial axes flipped, Cin and Cout swapped)."""
    nd = w.dim() - 2
    zero = torch.zeros(w.shape[nd], dtype=torch.float32, device=w.device)
    return w.flip(tuple(range(nd))).transpose(nd, nd + 1).contiguous(), zero


def conv3d_input_grad_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``conv3d_input_grad``, in f32, cast to g's dtype."""
    return conv3d_bn_relu_reference(g, *_flip_transpose(w), relu=False)


def conv2d_input_grad_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``conv2d_input_grad``, in f32, cast to g's dtype."""
    return conv2d_bn_relu_reference(g, *_flip_transpose(w), relu=False)


def _input_grad(g: torch.Tensor, w: torch.Tensor, nd: int) -> torch.Tensor:
    """dx of the k3 s1 SAME conv of rank nd for the cotangent g: the conv
    kernel on the flipped, transposed weights with no bias, read so by the
    kernel's wgmma variant straight from w; the other variants (f32, ragged
    channels) get the flipped copy."""
    name = f"conv{nd}d_input_grad"
    if w.dim() != nd + 2 or tuple(w.shape[:nd]) != (3,) * nd or w.shape[-1] != g.shape[-1]:
        raise ValueError(f"{name}: w must be [{'3,' * nd}Cin,{g.shape[-1]}], got {tuple(w.shape)}")
    if g.device.type == "cuda" and g.dim() == nd + 2 and g.is_contiguous() and w.is_contiguous() \
            and g.dtype == w.dtype and g.device == w.device and _tiled(g, w, w.shape[-2]):
        return _launch(g, w, None, relu=False, flip=True)
    w_t, zero = _flip_transpose(w)
    _check(g, w_t, zero, nd)
    if g.device.type == "cpu":
        return _reference(g, w_t, zero, relu=False)
    return _launch(g, w_t, zero, relu=False)


def conv3d_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [N,D,H,W,Cin] of y = conv3d_k3s1_same(x, w) for the cotangent g
    [N,D,H,W,Cout], in g's dtype; w [3,3,3,Cin,Cout] in g's dtype.

    The conv kernel on ``w.flip(0,1,2).transpose(3,4)`` with zero bias (its
    wgmma variant reads w so without a copy). A CUDA tensor launches it and
    adds one to ``conv3d_input_grad.launches`` (not to ``conv3d_bn_relu``'s);
    a CPU tensor runs the plain version."""
    dx = _input_grad(g, w, 3)
    if g.device.type == "cuda":
        _build.count_launch(conv3d_input_grad)
    return dx


conv3d_input_grad.launches = 0


def conv2d_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [N,H,W,Cin] of y = conv2d_k3s1_same(x, w) for the cotangent g
    [N,H,W,Cout], in g's dtype; w [3,3,Cin,Cout] in g's dtype.

    The 2-D conv kernel on ``w.flip(0,1).transpose(2,3)`` with zero bias, as
    the VJP of ``pallas_tlayout.conv2d_tlayout`` runs its dgrad (its wgmma
    variant reads w so without a copy). A CUDA tensor launches it and adds
    one to ``conv2d_input_grad.launches``; a CPU tensor runs the plain
    version."""
    dx = _input_grad(g, w, 2)
    if g.device.type == "cuda":
        _build.count_launch(conv2d_input_grad)
    return dx


conv2d_input_grad.launches = 0

# by spatial rank: forward, input gradient, weight gradient
_OPS = {3: (conv3d_bn_relu, conv3d_input_grad, conv3d_wgrad), 2: (conv2d_bn_relu, conv2d_input_grad, conv2d_wgrad)}


class _ConvK3S1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        w = weight.to(x.dtype).contiguous()
        ctx.save_for_backward(x, w)
        forward, _, _ = _OPS[x.dim() - 2]
        return forward(x, w, bias.float().contiguous(), relu=False)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        _, input_grad, wgrad = _OPS[x.dim() - 2]
        g = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:  # not for the stem, whose input is data
            dx = input_grad(g, w)
        if ctx.needs_input_grad[1]:
            dw = wgrad(x, g)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=tuple(range(g.dim() - 1)))
        return dx, dw, db


def conv3d_k3s1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """k3 s1 SAME conv3d + bias with gradients for x, weight and bias.

    x [N,D,H,W,Cin] float32 or bfloat16, contiguous (the compute dtype);
    weight [3,3,3,Cin,Cout] and bias [Cout] float32 parameters. The conv
    runs in x's dtype with f32 accumulation and returns x's dtype; the
    weight and bias gradients are float32."""
    if x.dim() != 5:
        raise ValueError(f"conv3d_k3s1: x must be [N,D,H,W,Cin], got {tuple(x.shape)}")
    return _ConvK3S1.apply(x, weight, bias)


def conv2d_k3s1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """k3 s1 SAME conv2d + bias with gradients for x, weight and bias:
    ``conv3d_k3s1`` for x [N,H,W,Cin] and weight [3,3,Cin,Cout], on the
    2-D kernels (``conv2d_bn_relu``, ``conv2d_input_grad``, ``conv2d_wgrad``)."""
    if x.dim() != 4:
        raise ValueError(f"conv2d_k3s1: x must be [N,H,W,Cin], got {tuple(x.shape)}")
    return _ConvK3S1.apply(x, weight, bias)
