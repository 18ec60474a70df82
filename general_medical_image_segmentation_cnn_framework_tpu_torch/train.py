"""Training entry point: UNet3D or UNet2D segmentation on the CUDA card.

Same CLI, run dir and checkpoints as the JAX package's ``train.py``::

    python -m general_medical_image_segmentation_cnn_framework_tpu_torch.train config=unet
    python -m general_medical_image_segmentation_cnn_framework_tpu_torch.train config=unet2d

A 2-D network (``models.is_2d``) trains on ``patch_size`` "1, H, W"
patches: ``models.make_forward`` drops the depth axis of the [B, 1, H, W, C]
batch and restores it on the logits, as the JAX package's ``make_forward``.

The options, as in the JAX package: ``optimizer`` adam | adamw
(``weight_decay`` on tensors of more than one dimension) | sgd
(``momentum``), ``grad_clip`` by global norm (``optim.py``); the per-epoch
StepLR (or cosine / poly) schedule with warmup; ``loss`` bce | dice | focal
| bce+dice, and softmax cross entropy on integer labels when
``out_classes > 2`` (``make_loss_and_metric``); ``grad_accum``
microbatches per optimizer step; ``ema_decay`` (``ema_checkpoint.ckpt``);
``val_interval`` validation by the sliding window with a
``best_checkpoint.ckpt``; ``remat`` / ``remat_policy`` (UNet3D); bf16
compute with f32 parameters (``precision``); ``data_backend=device``;
per-step loss/dice to TensorBoard; the latest checkpoint every epoch and
``checkpoint_%04d.ckpt`` every ``epochs_per_checkpoint``; resume with
``load_mode=1``; ``profile_dir`` (a ``torch.profiler`` trace of the loop);
``jax_debug_nans`` (``torch.autograd`` anomaly detection).

One train step is: forward (every k3 s1 conv is the hand-written kernel),
the loss and metric (binary BCE as one fused kernel), backward (the conv
input gradients on the forward kernel, the weight gradients on the wgrad
kernel, the fused loss's gradient in one kernel), the optimizer step;
BatchNorm updates its running statistics in the forward. Under
``grad_accum = A`` that is A forwards and backwards of B/A samples each,
then one optimizer step on the mean gradient. The step's scalars are read
one step late, so the host never waits on the card between steps.

It runs on the card unless ``config.platform=cpu``; without a card and
without that it raises. Keys this port does not carry yet are refused with
one error (``refuse_unported_keys``); the TPU-only keys get one log line.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .checkpoint import load_checkpoint, restore_training_state, save_checkpoint, save_epoch_checkpoints
from .config import compose, log_ignored_keys, resolve_device
from .data import make_dataset
from .logging_utils import AverageMeter, ProgressBars, TBWriter, get_logger, log_config
from .losses import bce_with_logits, cross_entropy, dice_loss, focal_loss, one_hot_background
from .metrics import dice_jaccard
from .models import build_model, make_forward
from .ops.fused_bce_dice import fused_bce_dice_metrics
from .optim import EMA, grads, make_optimizer, optimizer_name

# (key, test that it asks for something the port does not do, ROADMAP item)
_UNPORTED = (
    ("epoch_scan", bool, "queue 1 item 9"),
    ("spatial_sharding", bool, "queue 1 item 12"),
    ("param_sharding", lambda v: (v or "replicated") != "replicated", "queue 1 item 12"),
    ("pipeline_stages", lambda v: int(v or 0) > 1, "queue 1 item 12"),
)


def refuse_unported_keys(config) -> None:
    """One ``NotImplementedError`` naming every set key the port does not carry."""
    found = [
        f"{key}={config[key]!r} (ROADMAP {item})"
        for key, asks, item in _UNPORTED
        if key in config and asks(config[key])
    ]
    if found:
        raise NotImplementedError(
            "the PyTorch port does not carry these training options yet: " + "; ".join(found)
        )


def step_lr(init_lr: float, step_size: int, gamma: float, epoch: int) -> float:
    """torch StepLR after ``epoch`` completed epochs."""
    return init_lr * (gamma ** (epoch // step_size))


def make_scheduler(config) -> Callable[[int], float]:
    """Per-epoch learning rate ``f(completed_epochs) -> lr``: ``step`` (the
    reference's StepLR), ``cosine`` (to ``lr_min`` over ``epochs``) or
    ``poly``, each after an optional linear warmup from ``lr_min``; pure
    host floats, as in the JAX package."""
    import math

    name = str(getattr(config, "scheduler", "step") or "step").lower()
    init_lr = float(config.init_lr)
    epochs = max(int(config.epochs), 1)
    warmup = int(getattr(config, "warmup_epochs", 0) or 0)
    lr_min = float(getattr(config, "lr_min", 0.0) or 0.0)
    power = float(getattr(config, "lr_poly_power", 0.9) or 0.9)
    if name not in ("step", "cosine", "poly"):
        raise KeyError(f"unknown scheduler '{name}' (step | cosine | poly)")

    def schedule(epoch: int) -> float:
        if warmup and epoch < warmup:
            return lr_min + (init_lr - lr_min) * (epoch + 1) / warmup
        e = epoch - warmup
        span = max(epochs - warmup, 1)
        if name == "step":
            return step_lr(init_lr, config.scheduler_step_size, config.scheduler_gamma, e)
        if name == "cosine":
            t = min(e / span, 1.0)
            return lr_min + (init_lr - lr_min) * 0.5 * (1 + math.cos(math.pi * t))
        return lr_min + (init_lr - lr_min) * (1.0 - min(e / span, 1.0)) ** power

    return schedule


def make_loss_fn(config) -> Callable:
    """The criterion ``config.loss`` names over (logits, one-hot target):
    'bce' (default), 'dice', 'focal', 'bce+dice' (or 'dice+bce')."""
    name = getattr(config, "loss", "bce") or "bce"
    if name == "bce":
        return bce_with_logits
    if name == "dice":
        return dice_loss
    if name == "focal":
        return focal_loss
    if name in ("bce+dice", "dice+bce"):
        return lambda p, t: bce_with_logits(p, t) + dice_loss(p, t)
    raise KeyError(f"unknown loss '{name}' (bce | dice | focal | bce+dice)")


def make_loss_and_metric(config) -> Callable:
    """(logits, gt) -> (loss, dice) for the configured criterion:

    * binary BCE (``out_classes=2``, ``loss=bce``): the fused one-pass
      loss + metric kernel (``ops.fused_bce_dice``);
    * ``out_classes > 2``: softmax cross entropy on the integer labels in
      channel 0 of ``gt``, and the foreground dice;
    * any other loss: the criterion on ``one_hot_background(gt)`` and the
      dice of the argmax masks."""
    loss_name = getattr(config, "loss", "bce") or "bce"
    n_classes = int(config.out_classes)
    use_fused = n_classes == 2 and loss_name == "bce"
    multiclass = n_classes > 2
    criterion = make_loss_fn(config) if not multiclass else None

    def loss_and_metric(pred, gt):
        if use_fused:
            loss, _, dice = fused_bce_dice_metrics(pred, gt)
            return loss, dice
        if multiclass:
            labels = gt[..., 0].long()
            loss = cross_entropy(pred, labels)
            _, dice = dice_jaccard(labels > 0, pred.argmax(dim=-1) > 0)
            return loss, dice
        gt2 = one_hot_background(gt)
        loss = criterion(pred, gt2)
        _, dice = dice_jaccard(gt2.argmax(dim=-1), pred.argmax(dim=-1))
        return loss, dice

    return loss_and_metric


def make_train_step(
    forward: Callable, optimizer: torch.optim.Optimizer, loss_and_metric, grad_accum: int = 1,
) -> Callable:
    """``step(x, gt) -> (loss, dice)``, detached 0-d tensors on the device:
    forward (the model, or ``models.make_forward``'s adapter of it), loss,
    backward, ``optimizer.step``. BatchNorm running stats update in the
    forward (train mode).

    With ``grad_accum = A > 1`` the [B, ...] batch is A microbatches of B/A,
    taken in order with the parameters fixed: their gradients are summed and
    divided by A before the one optimizer step, BatchNorm's running
    statistics move once per microbatch, in order, and loss and dice are
    the means over the microbatches, as the JAX ``train_step_accum``."""

    def train_step(x: torch.Tensor, gt: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        if grad_accum <= 1:
            loss, dice = loss_and_metric(forward(x), gt)
            loss.backward()
            optimizer.step()
            return loss.detach(), dice.detach()
        b = x.shape[0]
        assert b % grad_accum == 0, f"grad_accum={grad_accum} must divide batch_size ({b})"
        loss_sum = dice_sum = torch.zeros((), device=x.device)
        for x_i, g_i in zip(x.chunk(grad_accum), gt.chunk(grad_accum)):
            loss, dice = loss_and_metric(forward(x_i), g_i)
            loss.backward()
            loss_sum, dice_sum = loss_sum + loss.detach(), dice_sum + dice.detach()
        torch._foreach_div_(grads(optimizer), float(grad_accum))
        optimizer.step()
        return loss_sum / grad_accum, dice_sum / grad_accum

    return train_step


def _warn_accum_semantics(config, accum: int) -> None:
    """The JAX package's notice for grad_accum with a dice-family loss."""
    loss_name = str(getattr(config, "loss", "bce") or "bce").lower()
    if accum > 1 and "dice" in loss_name:
        warnings.warn(
            f"grad_accum={accum} with loss='{loss_name}': the dice term is "
            "normalized PER MICROBATCH (its denominator is a global batch "
            "sum), so the accumulated gradient differs from the full-batch "
            "gradient; mean-reduced criteria (bce/focal) stay exact. "
            "BatchNorm running stats also update once per microbatch."
        )


def evaluate(config, model: torch.nn.Module, device: torch.device, logger) -> float:
    """Validation: the mean dice of the crop-mode sliding window over the
    volumes of ``config.val_data_path`` / ``val_gt_path`` (eval mode, so
    every ConvBlock is one BatchNorm-folded conv kernel), as the JAX
    ``evaluate``. Leaves ``model`` in train mode."""
    from .data.pipeline import load_subject
    from .data.transforms import ZNormalization
    from .metrics import multiclass_seg_metrics, seg_metrics
    from .ops.sliding_window import prepare_volume, sliding_window_predict
    from .predict import overlap_of

    pairs = list(zip(sorted(Path(config.val_data_path).glob("*.nii.gz")),
                     sorted(Path(config.val_gt_path).glob("*.nii.gz"))))
    if not pairs:
        logger.warning(f"no validation volumes under {config.val_data_path}")
        return float("nan")
    forward, znorm, dices = make_forward(config, model), ZNormalization(), []
    model.eval()
    try:
        for pair in pairs:
            subject = load_subject(pair)
            vol = prepare_volume(znorm.normalize_array(subject.source.data), device, model.dtype)
            mask = sliding_window_predict(
                forward, vol, config.patch_size, overlap_of(config), int(config.batch_size)
            )
            pred = mask.cpu().numpy()[None].astype(np.int32)
            if int(config.out_classes) > 2:
                _, dice = multiclass_seg_metrics(subject.gt.data, pred, int(config.out_classes))
            else:
                _, dice = seg_metrics(subject.gt.data, pred)
            dices.append(dice)
    finally:
        model.train()
    return float(np.mean(dices))


def _to_device(batch, device: torch.device) -> torch.Tensor:
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(batch)
    return t.to(device, non_blocking=True)


def train(config, model=None, logger=None) -> Dict[str, Any]:
    """Run the training loop; returns the final state (for tests)."""
    device = resolve_device(config)
    refuse_unported_keys(config)
    val_interval = int(getattr(config, "val_interval", 0) or 0)
    validate = bool(val_interval and getattr(config, "val_data_path", None))
    if validate:
        from .predict import refuse_unported_keys as refuse_unported_predict_keys

        refuse_unported_predict_keys(config, keys=("whole_volume",))  # what the JAX evaluate reads
    if model is None:
        model = build_model(config)
    if logger is None:
        logger = get_logger(config)
    log_ignored_keys(config, logger)
    logger.info(f"training on {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host CPU'})")

    model.to(device).train()
    opt_name = optimizer_name(config)
    optimizer = make_optimizer(config, model.parameters())
    loss_and_metric = make_loss_and_metric(config)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model '{config.network}': {n_params:,} parameters")

    elapsed_epochs = 0
    if config.load_mode == 1:
        ckpt_path = config.ckpt or os.path.join(config.hydra_path, config.latest_checkpoint_file)
        elapsed_epochs = restore_training_state(ckpt_path, model, optimizer, opt_name)
        logger.info(f"resumed from {ckpt_path} at epoch {elapsed_epochs}")

    # EMA of the parameters: a shadow on the device, updated after every
    # optimizer step, written as ema_checkpoint.ckpt (predict loads it)
    ema_decay = float(getattr(config, "ema_decay", 0.0) or 0.0)
    ema = None
    if ema_decay:
        ema = EMA(model, ema_decay)
        if elapsed_epochs:  # resume: recover the EMA history if it exists
            ema_path = os.path.join(os.path.dirname(str(ckpt_path)), "ema_checkpoint.ckpt")
            if os.path.exists(ema_path):
                ema.load(load_checkpoint(ema_path)["params"])
                logger.info(f"resumed EMA weights from {ema_path}")
            else:
                logger.warning(
                    f"resuming with ema_decay but no {ema_path}: the EMA "
                    "restarts from the restored raw params"
                )

    writer = TBWriter(config.hydra_path)
    dataset = make_dataset(config, is_train=True, device=device)
    accum = int(getattr(config, "grad_accum", 1) or 1)
    _warn_accum_semantics(config, accum)
    train_step = make_train_step(make_forward(config, model), optimizer, loss_and_metric, accum)

    lr_schedule = make_scheduler(config)
    use_scheduler = getattr(config, "use_scheduler", True)
    loss_meter, dice_meter = AverageMeter(), AverageMeter()
    load_meter, step_meter = AverageMeter(), AverageMeter()
    # resume continues the TensorBoard step axis where the previous run stopped
    iteration = elapsed_epochs * len(dataset)
    epochs = int(config.epochs)
    best_val_dice = float("-inf")

    progress = ProgressBars()
    epoch_task = progress.add_task("[red]epoch", total=epochs)
    batch_task = progress.add_task("[blue]batch", total=len(dataset))

    profile_dir = getattr(config, "profile_dir", None)
    with contextlib.ExitStack() as stack:
        if getattr(config, "jax_debug_nans", False):
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            stack.enter_context(profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)))

        for epoch in range(elapsed_epochs + 1, epochs + 1):
            loss_meter.reset(), dice_meter.reset(), load_meter.reset(), step_meter.reset()
            if use_scheduler:  # stepped per epoch, into every param group: this epoch's lr follows epoch-1 steps
                for group in optimizer.param_groups:
                    group["lr"] = lr_schedule(epoch - 1)

            def _log_step(p):
                # read a step's scalars (waits for the card to finish that step)
                nonlocal iteration
                i, loss_d, dice_d, bs, load_time, step_start = p
                loss_f, dice_f = float(loss_d), float(dice_d)
                iteration += 1
                writer.add_scalar("Training/Loss", loss_f, iteration)
                writer.add_scalar("Training/dice", dice_f, iteration)
                loss_meter.update(loss_f, bs)
                dice_meter.update(dice_f, bs)
                step_meter.update(time.time() - step_start)
                load_meter.update(load_time)
                progress.update(batch_task, completed=i + 1)
                logger.info(
                    f"\nEpoch: {epoch} Batch: {i}, data load time: {load_meter.val:.3f}s , "
                    f"train time: {step_meter.val:.3f}s\n"
                    f"Loss: {loss_meter.val}\nDice: {dice_meter.val}\n"
                )

            load_start = time.time()
            pending = None
            for i, (x, y) in enumerate(dataset):
                x, y = _to_device(x, device), _to_device(y, device)
                load_time = time.time() - load_start
                step_start = time.time()
                loss, dice = train_step(x, y)
                if ema is not None:
                    ema.update(model)
                # one-step-deferred scalar fetch: float() waits for the card, so
                # step i is read only after step i+1 is queued, and the card stays
                # busy through the host's logging; step_time is then the
                # pipelined wall time per step
                if pending is not None:
                    _log_step(pending)
                pending = (i, loss, dice, x.shape[0], load_time, step_start)
                load_start = time.time()
            if pending is not None:
                _log_step(pending)

            if use_scheduler:
                logger.info(f"Learning rate:  {optimizer.param_groups[0]['lr']}")
            logger.info(
                f"\nEpoch {epoch} used time:  {load_meter.sum + step_meter.sum:.3f} s\n"
                f"Loss Avg:  {loss_meter.avg}\nDice Avg:  {dice_meter.avg}\n"
            )
            save_epoch_checkpoints(config, config.hydra_path, epoch, model, optimizer, opt_name)
            if ema is not None and (epoch % int(config.epochs_per_checkpoint) == 0 or epoch == epochs):
                # the EMA weights with the run's BatchNorm statistics and no
                # optimizer state: predict-only (restore_training_state refuses it)
                save_checkpoint(os.path.join(config.hydra_path, "ema_checkpoint.ckpt"), ema.state_dict(model), epoch)

            if validate and epoch % val_interval == 0:
                val_dice = evaluate(config, model, device, logger)
                writer.add_scalar("Validation/dice", val_dice, epoch)
                logger.info(f"Epoch {epoch} validation dice: {val_dice:.4f}")
                if val_dice > best_val_dice:
                    best_val_dice = val_dice
                    save_checkpoint(
                        os.path.join(config.hydra_path, "best_checkpoint.ckpt"),
                        model.state_dict(), epoch, optimizer.state_dict(), opt_name,
                    )
                    logger.info(f"new best checkpoint (dice {val_dice:.4f})")

            progress.update(epoch_task, completed=epoch)
            progress.reset(batch_task, total=len(dataset))

    progress.stop()
    writer.close()
    return {
        "model": model,
        "optimizer": optimizer,
        "ema_params": None if ema is None else ema.state_dict(model),
        "epoch": epochs,
        "loss": loss_meter.avg,
        "dice": dice_meter.avg,
        "best_val_dice": best_val_dice,
    }


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    """CLI: ``python -m <package>.train config=unet config.KEY=V``."""
    import sys

    overrides = argv if argv is not None else sys.argv[1:]
    config = compose(overrides, job_name="train")
    model = build_model(config)
    logger = get_logger(config)
    log_config(logger, config)
    return train(config, model, logger)


if __name__ == "__main__":
    main()
