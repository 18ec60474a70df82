"""The port's losses against the JAX package's ``losses.py`` and the train
step's (loss, dice) of every criterion against the JAX
``make_loss_and_metric``: the same numpy inputs from a seed, f32 on the
CPU. Each loss within 1e-6 relative, and its gradient with respect to the
logits within 1e-6 of the gradient's largest entry (the JAX and torch
reductions sum in different orders)."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from general_medical_image_segmentation_cnn_framework_tpu import losses as jax_losses
from general_medical_image_segmentation_cnn_framework_tpu import train as jax_train
from general_medical_image_segmentation_cnn_framework_tpu.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu_torch import losses
from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train

SHAPE = (2, 6, 5, 4)  # [B, D, H, W]; channels last


def _inputs(seed, classes=2):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, size=SHAPE + (classes,)).astype(np.float32)
    binary = (rng.uniform(size=SHAPE + (1,)) > 0.6).astype(np.float32)
    labels = rng.integers(0, classes, size=SHAPE).astype(np.int32)
    return logits, binary, labels


def _one_hot(binary):
    return np.concatenate([(binary == 0).astype(np.float32), binary], axis=-1)


# name -> (JAX function of (x, aux), port function of (x, aux), aux from the inputs, classes)
CASES = {
    "bce_with_logits": (jax_losses.bce_with_logits, losses.bce_with_logits, lambda b, l: _one_hot(b), 2),
    "cross_entropy": (jax_losses.cross_entropy, losses.cross_entropy, lambda b, l: l, 4),
    "cross_entropy_weighted": (
        lambda x, t: jax_losses.cross_entropy(x, t, weight=jnp.asarray([0.5, 1.0, 2.0, 0.25]), size_average=False),
        lambda x, t: losses.cross_entropy(x, t, weight=torch.tensor([0.5, 1.0, 2.0, 0.25]), size_average=False),
        lambda b, l: l, 4,
    ),
    "binary_dice_loss": (
        lambda x, t: jax_losses.binary_dice_loss(jax.nn.sigmoid(x), t),
        lambda x, t: losses.binary_dice_loss(torch.sigmoid(x), t),
        lambda b, l: _one_hot(b), 2,
    ),
    "dice_loss": (jax_losses.dice_loss, losses.dice_loss, lambda b, l: _one_hot(b), 2),
    "multiclass_dice_loss": (
        lambda x, t: jax_losses.multiclass_dice_loss(x, t, 3, weight=[1.0, 2.0, 0.5], softmax=True),
        lambda x, t: losses.multiclass_dice_loss(x, t, 3, weight=[1.0, 2.0, 0.5], softmax=True),
        lambda b, l: l, 3,
    ),
    "focal_loss": (jax_losses.focal_loss, losses.focal_loss, lambda b, l: _one_hot(b), 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_its_gradient_match_jax(name):
    jax_fn, port_fn, aux_of, classes = CASES[name]
    logits, binary, labels = _inputs(sum(map(ord, name)), classes)
    labels = labels % classes
    aux = aux_of(binary, labels)
    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits), jnp.asarray(aux))
    x = torch.from_numpy(logits).requires_grad_()
    got = port_fn(x, torch.from_numpy(aux))
    (got_grad,) = torch.autograd.grad(got, x)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=0, atol=1e-6 * np.abs(want_grad).max())


def test_binary_dice_loss_reductions_match_jax():
    rng = np.random.default_rng(5)
    p, t = rng.uniform(size=(3, 4, 5)).astype(np.float32), (rng.uniform(size=(3, 4, 5)) > 0.5).astype(np.float32)
    for reduction in ("mean", "sum", "none"):
        want = np.asarray(jax_losses.binary_dice_loss(jnp.asarray(p), jnp.asarray(t), reduction=reduction))
        got = losses.binary_dice_loss(torch.from_numpy(p), torch.from_numpy(t), reduction=reduction).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="Unexpected reduction"):
        losses.binary_dice_loss(torch.from_numpy(p), torch.from_numpy(t), reduction="max")


@pytest.mark.parametrize("loss,classes", [("dice", 2), ("focal", 2), ("bce+dice", 2), ("dice+bce", 2), ("bce", 4)])
def test_train_loss_and_metric_match_jax(loss, classes):
    """``make_loss_and_metric``: the criterion on ``one_hot_background(gt)``
    with the argmax dice (binary), or softmax cross entropy on the labels in
    gt's channel 0 with the foreground dice (out_classes > 2); the loss and
    its logits gradient as above, the dice within 1e-6."""
    cfg = ConfigDict(loss=loss, out_classes=classes)
    logits, binary, labels = _inputs(7 + classes, classes)
    gt = binary if classes == 2 else labels[..., None].astype(np.float32)
    jax_fn = jax_train.make_loss_and_metric(cfg)
    (want, want_dice), want_grad = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(logits), jnp.asarray(gt))
    x = torch.from_numpy(logits).requires_grad_()
    got, got_dice = port_train.make_loss_and_metric(cfg)(x, torch.from_numpy(gt))
    (got_grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_dice.item(), float(want_dice), rtol=1e-6, atol=1e-7)
    assert 0.0 < got_dice.item() < 1.0
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=0, atol=1e-6 * np.abs(want_grad).max())


def test_unknown_loss_raises_the_jax_key_error():
    for make in (jax_train.make_loss_and_metric, port_train.make_loss_and_metric):
        with pytest.raises(KeyError, match="unknown loss 'hinge'"):
            make(ConfigDict(loss="hinge", out_classes=2))
