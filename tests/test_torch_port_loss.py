"""The port's fused BCE + dice loss/metric, its losses and its device-side
metrics against the JAX package's, on the same numpy-seeded inputs.

On the CPU the port's ``fused_bce_dice_metrics`` runs the kernels' plain
versions; it is held against the JAX Pallas kernels in interpret mode and
against the JAX reference composition (one-hot target, BCE, argmax dice).
Tolerances: loss 1e-5 relative (f32 sums in another order), jaccard and
dice 1e-6 (ratios of exact counts), gradient 1e-6 of its scale s = 1/(2V)
(the gradient is (sigmoid(l) - t) * s with |sigmoid(l) - t| <= 1, so this is
1e-6 absolute in units of s: a few f32 roundings of the sigmoid, and an
all-zero or wrong gradient fails it at any V). One exception, on the JAX side: where the
voxel count is not a multiple of 1024 the Pallas path pads and subtracts
2*log(2) per padded voxel in f32, which its own test bounds at 1e-4
absolute (tests/test_fused_ops.py); there the port's loss is also held to
a float64 numpy sum at 1e-6 relative.

The CUDA kernels run only on a card: the ``cuda``-marked cases skip
without one; on the card, ``python -m pytest --noconftest
tests/test_torch_port_loss.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from general_medical_image_segmentation_cnn_framework_tpu_torch import losses as port_losses
from general_medical_image_segmentation_cnn_framework_tpu_torch import metrics as port_metrics
from general_medical_image_segmentation_cnn_framework_tpu_torch.ops.fused_bce_dice import (
    bce_dice_grads,
    bce_dice_grads_reference,
    bce_dice_sums,
    bce_dice_sums_reference,
    fused_bce_dice_metrics,
)

SHAPES = [(2, 8, 8, 8), (1, 5, 7, 3)]  # 1024 voxels, and 105: not a multiple of 1024


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, size=shape + (2,)).astype(np.float32)
    gt = (rng.uniform(size=shape + (1,)) > 0.6).astype(np.float32)
    return logits, gt


def _port(logits, gt):
    lt = torch.from_numpy(logits).requires_grad_()
    loss, jac, dice = fused_bce_dice_metrics(lt, torch.from_numpy(gt))
    loss.backward()
    return loss.item(), jac.item(), dice.item(), lt.grad.numpy()


def _assert_close(got, want, loss_atol=0.0):
    loss, jac, dice, grad = got
    w_loss, w_jac, w_dice, w_grad = want
    assert abs(loss - w_loss) <= max(1e-5 * abs(w_loss), loss_atol)
    assert abs(jac - w_jac) <= 1e-6 and abs(dice - w_dice) <= 1e-6
    scale = 1.0 / grad.size  # s = 1/(2V): the loss is the mean of 2V BCE terms
    np.testing.assert_allclose(grad, w_grad, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_matches_jax_pallas_interpret_and_reference(shape, monkeypatch):
    import jax
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu import losses, metrics
    from general_medical_image_segmentation_cnn_framework_tpu.ops import fused

    logits, gt = _inputs(shape, seed=sum(shape))
    got = _port(logits, gt)
    x, t = logits.astype(np.float64), np.concatenate([1 - gt, gt], -1).astype(np.float64)
    exact = np.mean(np.maximum(x, 0) - x * t + np.log1p(np.exp(-np.abs(x))))
    assert abs(got[0] - exact) <= 1e-6 * exact
    g = jnp.asarray(gt)
    padded = np.prod(shape) % 1024 != 0

    def jax_fused(l):
        return fused.fused_bce_dice_metrics(l, g)

    def jax_reference(l):
        gt2 = losses.one_hot_background(g)
        jac, dice = metrics.dice_jaccard(jnp.argmax(gt2, -1), jnp.argmax(l, -1))
        return losses.bce_with_logits(l, gt2), jac, dice

    monkeypatch.setattr(fused, "_FORCE_PALLAS", True)
    monkeypatch.setattr(fused, "_INTERPRET", True)
    for fn in (jax_fused, jax_reference):
        loss, jac, dice = fn(jnp.asarray(logits))
        grad = jax.grad(lambda l: fn(l)[0])(jnp.asarray(logits))
        atol = 1e-4 if fn is jax_fused and padded else 0.0
        _assert_close(got, (float(loss), float(jac), float(dice), np.asarray(grad)), atol)


def test_losses_and_device_metrics_match_jax():
    import jax.numpy as jnp

    from general_medical_image_segmentation_cnn_framework_tpu import losses, metrics

    logits, gt = _inputs((2, 4, 5, 3), seed=7)
    gt2 = port_losses.one_hot_background(torch.from_numpy(gt))
    np.testing.assert_array_equal(gt2.numpy(), np.asarray(losses.one_hot_background(jnp.asarray(gt))))
    got = port_losses.bce_with_logits(torch.from_numpy(logits), gt2)
    want = losses.bce_with_logits(jnp.asarray(logits), jnp.asarray(gt2.numpy()))
    assert got.dtype == torch.float32 and abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    pred = logits.argmax(-1)
    counts = port_metrics.confusion_counts(torch.from_numpy(gt[..., 0]), torch.from_numpy(pred))
    np.testing.assert_array_equal(
        [float(c) for c in counts],
        [float(c) for c in metrics.confusion_counts(jnp.asarray(gt[..., 0]), jnp.asarray(pred))],
    )
    jac, dice = port_metrics.dice_jaccard(torch.from_numpy(gt[..., 0]), torch.from_numpy(pred))
    w_jac, w_dice = metrics.dice_jaccard(jnp.asarray(gt[..., 0]), jnp.asarray(pred))
    assert abs(float(jac) - float(w_jac)) <= 1e-7 and abs(float(dice) - float(w_dice)) <= 1e-7


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    logits, gt = (torch.from_numpy(a) for a in _inputs((1, 3, 4, 5), seed=2))
    scale = torch.tensor([0.25])
    before = (bce_dice_sums.launches, bce_dice_grads.launches)
    torch.testing.assert_close(bce_dice_sums(logits, gt), bce_dice_sums_reference(logits, gt), rtol=0, atol=0)
    torch.testing.assert_close(
        bce_dice_grads(logits, gt, scale), bce_dice_grads_reference(logits, gt, scale), rtol=0, atol=0
    )
    assert (bce_dice_sums.launches, bce_dice_grads.launches) == before
    with pytest.raises(ValueError):
        bce_dice_sums(logits, gt[..., :2, :])
    with pytest.raises(TypeError):
        bce_dice_sums(logits, gt.double())
    with pytest.raises(TypeError):  # the model's logits are float32; no bf16 variant
        bce_dice_grads(logits.bfloat16(), gt, scale)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 5, 7, 3), (2, 8, 8, 8), (3, 17, 19, 23), (16, 64, 64, 64)])
@pytest.mark.parametrize("train_scale", [True, False])
@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device, shape, train_scale):
    """The gradient at the train step's scale s = 1/(2V) and at s = 1, each
    within 1e-6 * s (the gradient is (sigmoid(l) - t) * s, |.| <= s)."""
    logits, gt = (torch.from_numpy(a).to(cuda_device) for a in _inputs(shape, seed=len(shape)))
    s = 0.5 / logits[..., 0].numel() if train_scale else 1.0
    scale = torch.tensor([s], device=cuda_device)
    before = (bce_dice_sums.launches, bce_dice_grads.launches)
    got = bce_dice_sums(logits, gt)
    again = bce_dice_sums(logits, gt)
    d = bce_dice_grads(logits, gt, scale)
    torch.cuda.synchronize()
    assert (bce_dice_sums.launches, bce_dice_grads.launches) == (before[0] + 2, before[1] + 1)
    want = bce_dice_sums_reference(logits, gt)
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # the same on every run
    assert abs(got[0].item() - want[0].item()) <= 1e-5 * abs(want[0].item())
    assert got[1:].tolist() == want[1:].tolist()  # the counts are exact
    d_want = bce_dice_grads_reference(logits, gt, scale)
    assert d.dtype == torch.float32 and d.shape == logits.shape
    assert d_want.abs().max().item() >= 0.5 * s  # the limit below is far under the gradient's size
    assert (d - d_want).abs().max().item() <= 1e-6 * s
