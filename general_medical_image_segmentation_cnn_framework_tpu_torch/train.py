"""Training entry point: UNet3D or UNet2D binary segmentation on the CUDA card.

Same CLI, run dir and checkpoints as the JAX package's ``train.py`` on its
default path::

    python -m general_medical_image_segmentation_cnn_framework_tpu_torch.train config=unet
    python -m general_medical_image_segmentation_cnn_framework_tpu_torch.train config=unet2d

A 2-D network (``models.is_2d``) trains on ``patch_size`` "1, H, W"
patches: ``models.make_forward`` drops the depth axis of the [B, 1, H, W, C]
batch and restores it on the logits, as the JAX package's ``make_forward``.

Adam(init_lr) with the per-epoch StepLR (or cosine / poly) schedule,
BCE-with-logits on the (background, foreground) target with the dice
metric from the same pass, bf16 compute with f32 parameters
(``precision``), the volumes resident on the device
(``data_backend=device``), per-step loss/dice to TensorBoard, the latest
checkpoint every epoch and ``checkpoint_%04d.ckpt`` every
``epochs_per_checkpoint``, and resume with ``load_mode=1``.

One train step is: forward (every k3 s1 conv is the hand-written kernel),
the fused loss + metric (one kernel), backward (the conv input gradients
on the forward kernel, the weight gradients on the wgrad kernel, the loss
gradient in one kernel), ``Adam.step``; BatchNorm updates its running
statistics in the forward. The step's scalars are read one step late, so
the host never waits on the card between steps.

It runs on the card unless ``config.platform=cpu``; without a card and
without that it raises. Keys this port does not carry yet are refused with
one error (``refuse_unported_keys``); the TPU-only keys get one log line.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from .checkpoint import restore_training_state, save_epoch_checkpoints
from .config import compose, log_ignored_keys, resolve_device
from .data import make_dataset
from .logging_utils import AverageMeter, ProgressBars, TBWriter, get_logger, log_config
from .models import build_model, make_forward
from .ops.fused_bce_dice import fused_bce_dice_metrics

# (key, test that it asks for something the port does not do, ROADMAP item)
_UNPORTED = (
    ("grad_accum", lambda v: int(v or 1) > 1, "queue 1 item 8"),
    ("ema_decay", lambda v: float(v or 0) > 0, "queue 1 item 8"),
    ("val_interval", lambda v: int(v or 0) > 0, "queue 1 item 8"),
    ("remat", bool, "queue 1 item 8"),
    ("profile_dir", bool, "queue 1 item 8"),
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


def optimizer_name(config) -> str:
    return str(getattr(config, "optimizer", "adam") or "adam").lower()


def make_optimizer(config, params) -> torch.optim.Optimizer:
    """``torch.optim.Adam(init_lr)``: optax.adam's defaults (b1 0.9, b2
    0.999, eps 1e-8) and its update, lr * m_hat / (sqrt(v_hat) + eps)."""
    name = optimizer_name(config)
    if name not in ("adam", "adamw", "sgd"):
        raise KeyError(f"unknown optimizer '{name}' (adam | adamw | sgd)")
    if name != "adam" or float(getattr(config, "grad_clip", 0.0) or 0.0) > 0.0:
        raise NotImplementedError(
            f"optimizer={name!r} / grad_clip={getattr(config, 'grad_clip', 0.0)!r}: the PyTorch "
            "port has adam without clipping only so far (ROADMAP queue 1 item 8)"
        )
    return torch.optim.Adam(params, lr=float(config.init_lr), betas=(0.9, 0.999), eps=1e-8)


def make_loss_and_metric(config) -> Callable:
    """(logits, gt) -> (loss, dice): the binary BCE criterion through the
    fused one-pass kernel."""
    loss_name = getattr(config, "loss", "bce") or "bce"
    if int(config.out_classes) != 2 or loss_name != "bce":
        raise NotImplementedError(
            f"loss={loss_name!r} with out_classes={config.out_classes}: the PyTorch port trains "
            "binary BCE (out_classes=2, loss=bce) only so far (ROADMAP queue 1 item 8)"
        )

    def loss_and_metric(pred, gt):
        loss, _, dice = fused_bce_dice_metrics(pred, gt)
        return loss, dice

    return loss_and_metric


def make_train_step(forward: Callable, optimizer: torch.optim.Optimizer, loss_and_metric) -> Callable:
    """``step(x, gt) -> (loss, dice)``, detached 0-d tensors on the device:
    forward (the model, or ``models.make_forward``'s adapter of it), loss,
    backward, ``optimizer.step``. BatchNorm running stats update in the
    forward (train mode)."""

    def train_step(x: torch.Tensor, gt: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        pred = forward(x)
        loss, dice = loss_and_metric(pred, gt)
        loss.backward()
        optimizer.step()
        return loss.detach(), dice.detach()

    return train_step


def _to_device(batch, device: torch.device) -> torch.Tensor:
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(batch)
    return t.to(device, non_blocking=True)


def train(config, model=None, logger=None) -> Dict[str, Any]:
    """Run the training loop; returns the final state (for tests)."""
    device = resolve_device(config)
    refuse_unported_keys(config)
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

    writer = TBWriter(config.hydra_path)
    dataset = make_dataset(config, is_train=True, device=device)
    train_step = make_train_step(make_forward(config, model), optimizer, loss_and_metric)

    lr_schedule = make_scheduler(config)
    use_scheduler = getattr(config, "use_scheduler", True)
    loss_meter, dice_meter = AverageMeter(), AverageMeter()
    load_meter, step_meter = AverageMeter(), AverageMeter()
    # resume continues the TensorBoard step axis where the previous run stopped
    iteration = elapsed_epochs * len(dataset)
    epochs = int(config.epochs)

    progress = ProgressBars()
    epoch_task = progress.add_task("[red]epoch", total=epochs)
    batch_task = progress.add_task("[blue]batch", total=len(dataset))

    for epoch in range(elapsed_epochs + 1, epochs + 1):
        loss_meter.reset(), dice_meter.reset(), load_meter.reset(), step_meter.reset()
        if use_scheduler:  # stepped per epoch: this epoch's lr follows epoch-1 steps
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
        progress.update(epoch_task, completed=epoch)
        progress.reset(batch_task, total=len(dataset))

    progress.stop()
    writer.close()
    return {
        "model": model,
        "optimizer": optimizer,
        "epoch": epochs,
        "loss": loss_meter.avg,
        "dice": dice_meter.avg,
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
