"""Fused k3 s1 SAME Conv3d + folded BatchNorm + ReLU on NDHWC tensors.

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
and in ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


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


def conv3d_bn_relu_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv3d`` + bias (+ ReLU) in f32, cast to
    x's dtype. x [N,D,H,W,Cin], w [3,3,3,Cin,Cout], b [Cout] -> [N,D,H,W,Cout]."""
    y = F.conv3d(
        x.float().permute(0, 4, 1, 2, 3),
        w.float().permute(4, 3, 0, 1, 2),
        b.float(),
        padding=1,
    )
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3d_bn_relu: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or x.numel() == 0:
        raise ValueError(f"conv3d_bn_relu: x must be a non-empty [N,D,H,W,Cin], got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 5 or tuple(w.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"conv3d_bn_relu: w must be [3,3,3,{cin},Cout], got {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"conv3d_bn_relu: w must have x's dtype {x.dtype}, got {w.dtype}")
    if tuple(b.shape) != (w.shape[-1],) or b.dtype != torch.float32:
        raise ValueError(
            f"conv3d_bn_relu: b must be float32 [{w.shape[-1]}], got {b.dtype} {tuple(b.shape)}"
        )
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3d_bn_relu: x, w and b must be contiguous")
    if not (x.device == w.device == b.device):
        raise ValueError(
            f"conv3d_bn_relu: x, w and b must share a device, got {x.device}, {w.device}, {b.device}"
        )


@functools.cache
def _kernel():
    lib = _build.load("conv3d_bn_relu")
    fn = lib.conv3d_bn_relu_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3d_bn_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """y = [relu](conv3d_k3s1_same(x, w) + b), NDHWC in x's dtype.

    x [N,D,H,W,Cin] float32 or bfloat16; w [3,3,3,Cin,Cout] in x's dtype
    (BN folded in); b float32 [Cout]. A CUDA tensor runs the CUDA kernel and
    adds one to ``conv3d_bn_relu.launches``; a CPU tensor runs
    ``conv3d_bn_relu_reference``."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3d_bn_relu_reference(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_bn_relu: unsupported device {x.device}")
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    err = _kernel()(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, d, h, wd, cin, cout, int(relu), int(x.dtype == torch.bfloat16),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv3d_bn_relu: CUDA launch failed with cudaError {err}")
    conv3d_bn_relu.launches += 1
    return y


conv3d_bn_relu.launches = 0
