"""The port's checkpoint file: ``{"params": state_dict, "epoch": int}``.

Written with ``torch.save`` and read with ``torch.load(weights_only=True)``,
so loading runs no pickled code. ``convert.py`` turns a JAX msgpack
``.ckpt`` into this format.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Union

import torch


def save_checkpoint(path: Union[str, Path], params: Dict[str, torch.Tensor], epoch: int) -> None:
    state = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "epoch": int(epoch),
    }
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: Union[str, Path]) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)
