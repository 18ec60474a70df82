"""The port's checkpoint file:
``{"params": state_dict, "opt_state": optimizer.state_dict(), "epoch": int,
"optimizer": name}``.

``params`` is the model's ``state_dict``, BatchNorm running statistics
included; ``optimizer`` is adam, adamw or sgd. Training writes all four
keys (``save_epoch_checkpoints``: the latest file every epoch,
``checkpoint_%04d.ckpt`` every ``epochs_per_checkpoint``, as the JAX
package does, and ``best_checkpoint.ckpt`` when validation improves); a
weights-only file (``ema_checkpoint.ckpt``, ``convert.py`` of a JAX
checkpoint without optimizer state, or an older port file of
``{"params", "epoch"}``) serves predict, which reads ``params`` alone. Written with ``torch.save`` through a temporary file and
read with ``torch.load(weights_only=True)``, so loading runs no pickled
code. ``restore_training_state`` resumes training (``load_mode=1``) and
refuses a file written by another optimizer.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(
    path: Union[str, Path],
    params: Dict[str, torch.Tensor],
    epoch: int,
    opt_state: Optional[Dict] = None,
    optimizer: Optional[str] = None,
) -> None:
    state = {
        "params": _to_cpu(params),
        "opt_state": _to_cpu(opt_state),
        "epoch": int(epoch),
        "optimizer": optimizer,
    }
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: Union[str, Path]) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_epoch_checkpoints(
    config, run_dir: Union[str, Path], epoch: int, model: torch.nn.Module,
    optimizer: torch.optim.Optimizer, optimizer_name: str,
) -> None:
    """The latest checkpoint every epoch and ``checkpoint_%04d.ckpt`` every
    ``config.epochs_per_checkpoint`` epochs."""
    run_dir = Path(run_dir)
    args = (model.state_dict(), epoch, optimizer.state_dict(), optimizer_name)
    save_checkpoint(run_dir / config.latest_checkpoint_file, *args)
    if epoch % int(config.epochs_per_checkpoint) == 0:
        save_checkpoint(run_dir / f"checkpoint_{epoch:04d}.ckpt", *args)


def restore_training_state(
    path: Union[str, Path], model: torch.nn.Module, optimizer: torch.optim.Optimizer,
    optimizer_name: str,
) -> int:
    """Load weights, BatchNorm statistics and optimizer state from ``path``
    into ``model`` and ``optimizer``; returns the stored epoch. Raises
    ``ValueError`` for a file without optimizer state or written by another
    optimizer.

    The moments, traces and step counts come from the file; the
    hyperparameters (learning rate, weight decay, momentum) stay those
    ``optimizer`` was built with from the run's config, as in optax, where
    they are not state: ``load_state_dict`` would bring back the file's."""
    state = load_checkpoint(path)
    if state.get("opt_state") is None:
        raise ValueError(
            f"{path} holds no optimizer state: it is a predict-only, weights-only checkpoint (an "
            "ema_checkpoint.ckpt, or a converted file without optimizer state); load_mode=1 resumes "
            "only from a checkpoint written by train with its optimizer state"
        )
    if state.get("optimizer") != optimizer_name:
        raise ValueError(
            f"{path} was written by optimizer {state.get('optimizer')!r} and this run uses "
            f"{optimizer_name!r}: its optimizer state does not fit; resume with the same optimizer"
        )
    model.load_state_dict(state["params"])
    hyperparams = [{k: v for k, v in group.items() if k != "params"} for group in optimizer.param_groups]
    optimizer.load_state_dict(state["opt_state"])
    for group, hp in zip(optimizer.param_groups, hyperparams):
        group.update(hp)
    return int(state["epoch"])
