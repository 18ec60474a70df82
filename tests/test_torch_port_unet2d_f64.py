"""How exact the port's UNet2D train-step gradient is in f32, against the
same step in f64 (conv, input gradient, weight gradient, bilinear up and
loss in f64; BatchNorm computes its statistics in f32 by design).

The weights and inputs are those of the gradient parity test of
``test_torch_port_unet2d.py`` (random BatchNorm affine parameters and conv
biases from the JAX model's tree). At full width (batch 4, 32^2) a few
pre-ReLU values then lie within f32 noise of 0, so the two runs' ReLU
masks differ there and train-mode BatchNorm spreads each flip over its
channel; that alone sets how far the gradients of two f32 runs (the
port's and the JAX package's, the card's and the CPU's) can differ. With
the f64 run's masks given to the f32 run, the f32 gradient must match the
f64 one to 1e-4 of each tensor's largest entry; without them the worst
errors are printed (run with ``-s``) and the norm-relative one is held to
the 1e-2 that the parity checks allow. The kernels' wrappers take float32
and bfloat16 only, so the test lets them take float64 too.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the weights come from the JAX model's tree, as in the parity test

from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import conv3d_bn_relu, conv3d_wgrad  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.models import make_forward  # noqa: E402
from test_torch_port_unet2d import _x, jax_unet2d, port_unet2d  # noqa: E402

CONFIG = ConfigDict(network="unet2d", out_classes=2, loss="bce")


def _gradients(model, x, gt, dtype, masks, record):
    model = model.to(dtype).train()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = dtype
    for i, block in enumerate(model.blocks):

        def forward(z, block=block, i=i):
            y = block.bn(block.conv(z))
            if record:
                masks[i] = y > 0
            return y * masks[i].to(y.dtype) if masks else torch.relu(y)

        block.forward = forward
    pred = make_forward(CONFIG, model)(torch.from_numpy(x).to(dtype))
    target = torch.from_numpy(gt).to(dtype)
    # the fused loss is f32; this is its BCE (mean over both planes) in the run's dtype
    loss = torch.nn.functional.binary_cross_entropy_with_logits(pred, torch.cat([1 - target, target], -1))
    loss.backward()
    return {n: p.grad.double() for n, p in model.named_parameters() if not n.endswith("conv.bias")}


def test_f32_gradient_matches_f64_once_relu_masks_agree(monkeypatch):
    for module in (conv3d_bn_relu, conv3d_wgrad):
        monkeypatch.setattr(module, "_DTYPES", (torch.float32, torch.bfloat16, torch.float64))
    _, variables = jax_unet2d(seed=3)
    x = _x((4, 1, 32, 32, 1), 4)
    gt = (np.random.default_rng(5).uniform(size=(4, 1, 32, 32, 1)) > 0.7).astype(np.float32)

    def model():
        return port_unet2d(variables)

    masks = {}
    want = _gradients(model(), x, gt, torch.float64, masks, record=True)
    shared = _gradients(model(), x, gt, torch.float32, masks, record=False)
    free = _gradients(model(), x, gt, torch.float32, {}, record=False)
    worst_shared = max(((shared[n] - w).abs().max() / w.abs().max()).item() for n, w in want.items())
    worst_free = max(((free[n] - w).abs().max() / w.abs().max()).item() for n, w in want.items())
    worst_free_l2 = max(((free[n] - w).norm() / w.norm()).item() for n, w in want.items())
    print(f"f32 vs f64 gradients: {worst_shared:.3g} of the largest entry with shared ReLU masks; "
          f"without, {worst_free:.3g} of the largest entry and {worst_free_l2:.3g} in relative L2 norm")
    assert worst_shared <= 1e-4
    assert worst_free_l2 <= 1e-2
