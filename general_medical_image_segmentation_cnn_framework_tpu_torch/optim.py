"""Optimizers, global-norm clipping and the parameter EMA of the train step.

The counterparts of the JAX package's ``train.make_optimizer`` (optax) and
its EMA shadow tree:

* ``adam``: ``torch.optim.Adam``, optax.adam's defaults (b1 0.9, b2 0.999,
  eps 1e-8); torch's lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps) is optax's
  lr * m_hat / (sqrt(v_hat) + eps);
* ``adamw``: ``torch.optim.AdamW`` in two parameter groups: the decoupled
  ``weight_decay`` applies to the tensors of more than one dimension only
  (the optax mask ``jnp.ndim(p) > 1``), so BatchNorm's scale and shift and
  every bias keep ``weight_decay = 0``;
* ``sgd``: ``torch.optim.SGD`` with ``momentum`` (dampening 0, no
  Nesterov), whose buffer g + m * buf is optax.sgd's trace; plain SGD at
  momentum 0;
* ``grad_clip > 0``: optax.clip_by_global_norm in front of any of them, as
  a step pre-hook of the optimizer: every gradient becomes g / ‖g‖ * clip
  where the global norm ‖g‖ over all of them is at least ``clip``.
  (``torch.nn.utils.clip_grad_norm_`` divides by ‖g‖ + 1e-6: another
  function.)

In optax only the moments, traces and counts are state; the learning rate,
weight decay, momentum and clip are constants of the config, and
``checkpoint.restore_training_state`` keeps them so.

For a CUDA graph of the train step (``ops/epoch_scan.py``),
``make_capturable`` keeps Adam's and AdamW's step counts and learning rate
on the device (``capturable=True``, a tensor ``lr`` that ``set_lr`` writes
in place, so the per-epoch schedule reaches every replay); SGD's learning
rate stays a float, which a graph bakes in.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

OPTIMIZERS = ("adam", "adamw", "sgd")


def optimizer_name(config) -> str:
    return str(getattr(config, "optimizer", "adam") or "adam").lower()


def _hyperparams(config) -> Dict[str, float]:
    return {
        "weight_decay": float(getattr(config, "weight_decay", 0.0) or 0.0),
        "momentum": float(getattr(config, "momentum", 0.0) or 0.0),
        "grad_clip": float(getattr(config, "grad_clip", 0.0) or 0.0),
    }


def make_optimizer(config, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """The optimizer ``config.optimizer`` names over ``params``, at
    ``config.init_lr``, with global-norm clipping when ``config.grad_clip > 0``."""
    name = optimizer_name(config)
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer '{name}' (adam | adamw | sgd)")
    hp = _hyperparams(config)
    params = list(params)
    lr = float(config.init_lr)
    if name == "adam":
        optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        groups = [
            {"params": [p for p in params if p.dim() > 1], "weight_decay": hp["weight_decay"]},
            {"params": [p for p in params if p.dim() <= 1], "weight_decay": 0.0},
        ]
        optimizer = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        optimizer = torch.optim.SGD(params, lr=lr, momentum=hp["momentum"])
    if hp["grad_clip"] > 0.0:
        clip = hp["grad_clip"]
        optimizer.register_step_pre_hook(lambda opt, args, kwargs: clip_by_global_norm_(opt, clip))
    return optimizer


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate: a float, or written in place into the
    group's device tensor (``make_capturable``), which a captured step reads."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def make_capturable(optimizer: torch.optim.Optimizer) -> bool:
    """Prepare an optimizer on the card for CUDA graph capture. Adam and
    AdamW (``capturable=True``): step counts on the parameters' device and
    the learning rate a device tensor; True. SGD has no capturable state and
    its learning rate stays a float: False (a graph of its step holds the
    learning rate it was captured with)."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return False
    for group in optimizer.param_groups:
        device = group["params"][0].device
        group["capturable"] = True
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32, device=device)
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                state["step"] = state["step"].to(p.device)
    return True


def grads(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The gradients of the optimizer's parameters that have one."""
    return [p.grad for group in optimizer.param_groups for p in group["params"] if p.grad is not None]


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for each of the optimizer's parameters that autograd
    gave none (one that does not reach the loss). torch's optimizers skip
    such a parameter; optax updates every leaf of the tree, with the zero
    gradient ``jax.grad`` gives it, so AdamW's decay shrinks it and every
    parameter's step count stays the same."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def clip_by_global_norm_(optimizer: torch.optim.Optimizer, max_norm: float) -> None:
    """optax.clip_by_global_norm on the optimizer's gradients, in place and
    on the device: g stays g where ‖g‖ < max_norm, else g / ‖g‖ * max_norm."""
    gs = grads(optimizer)
    if not gs:
        return
    norm = torch.stack([n.float() for n in torch._foreach_norm(gs)]).square().sum().sqrt()
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(gs, torch.where(keep, one, norm))
    torch._foreach_mul_(gs, torch.where(keep, one, torch.full_like(norm, max_norm)))


class EMA:
    """A float32 shadow of the model's parameters (not of its BatchNorm
    buffers), updated after each optimizer step as d * ema + (1 - d) * p."""

    def __init__(self, model: torch.nn.Module, decay: float):
        assert 0.0 < decay < 1.0, f"ema_decay={decay} must be in (0,1)"
        self.decay = decay
        self.names = [name for name, _ in model.named_parameters()]
        self.shadow = [p.detach().float().clone() for _, p in model.named_parameters()]

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        params = [p.detach() for p in model.parameters()]
        torch._foreach_mul_(self.shadow, self.decay)
        torch._foreach_add_(self.shadow, params, alpha=1.0 - self.decay)

    @torch.no_grad()
    def load(self, params: Dict[str, torch.Tensor]) -> None:
        """Take the shadow from a state dict's parameters (a saved EMA file)."""
        for t, name in zip(self.shadow, self.names):
            t.copy_(params[name])

    def state_dict(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """``model.state_dict()`` with the EMA in place of every parameter:
        the EMA weights with the run's own BatchNorm statistics."""
        ema = dict(zip(self.names, self.shadow))
        return {name: ema.get(name, t) for name, t in model.state_dict().items()}
