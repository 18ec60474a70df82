"""Device-side patch sampling: the training volumes live on the device and
every epoch's patches are cropped there.

The counterpart of the JAX package's ``data/device_prep.py``
(``data_backend=device``, the default): each volume crosses to the device
once and is z-normalised there; each epoch visits the volumes in a random
order and cuts ``samples_per_volume`` uniform random patches from each,
batches of ``batch_size`` with the last partial batch dropped. The order
and the patch origins come from a ``torch.Generator`` seeded with
``config.seed`` + epoch, so a run is reproducible; they are not the JAX
package's random numbers.

The whole dataset must fit in ``config.device_dataset_gb``; above it the
constructor raises ``DeviceDatasetBudgetError`` before any transfer and
``data.make_dataset`` falls back to the threaded host pipeline.
``aug=true`` needs the on-device augmentation, which is not ported yet.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .pipeline import get_subjects, load_subject


class DeviceDatasetBudgetError(RuntimeError):
    """Dataset too large for the device-resident backend (device_dataset_gb)."""


def znorm(vol: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the whole volume, in f32 (tio.ZNormalization);
    a constant volume is only centred."""
    vol = vol.float()
    std = vol.std(correction=0)
    return (vol - vol.mean()) / torch.where(std == 0, torch.ones_like(std), std)


class DevicePatchDataset:
    """Iterable of (x [B, *patch, C], y [B, *patch, 1]) f32 batches on
    ``device``; tio.Queue sampler semantics."""

    def __init__(self, config, is_train: bool = True, device: torch.device = torch.device("cpu")):
        if bool(getattr(config, "aug", False)) and is_train:
            raise NotImplementedError(
                "aug=true with data_backend=device needs the on-device augmentation "
                "(data/device_aug.py of the JAX package), which the PyTorch port does not have "
                "yet: ROADMAP queue 1 item 9 (device_aug). Use data_backend=threaded for host "
                "augmentation."
            )
        pairs = get_subjects(config)
        if not pairs:
            raise FileNotFoundError(
                f"no .nii.gz pairs found under {config.data_path} / {config.gt_path}"
            )
        self.device = torch.device(device)
        self.patch_size = tuple(int(p) for p in config.patch_size)
        self.batch_size = int(config.batch_size)
        self.samples_per_volume = int(getattr(config, "samples_per_volume", 10))
        self.seed = int(getattr(config, "seed", 0) or 0)
        self._epoch = 0

        budget = float(getattr(config, "device_dataset_gb", 8.0) or 0) * (1 << 30)
        host: List[Tuple[np.ndarray, np.ndarray]] = []
        total = 0
        for pair in pairs:
            subject = load_subject(pair)
            src = np.ascontiguousarray(np.moveaxis(subject.source.data, 0, -1), dtype=np.float32)
            gt = np.ascontiguousarray(np.moveaxis(subject.gt.data, 0, -1), dtype=np.float32)
            total += src.nbytes + gt.nbytes
            host.append((src, gt))
        if budget and total > budget:
            raise DeviceDatasetBudgetError(
                f"device data backend needs {total / (1 << 30):.2f} GB resident on the device "
                f"(> device_dataset_gb={budget / (1 << 30):.2f}); raise device_dataset_gb or "
                "use data_backend=threaded"
            )
        self.volumes: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (znorm(torch.from_numpy(src).to(self.device)), torch.from_numpy(gt).to(self.device))
            for src, gt in host
        ]

    def __len__(self) -> int:
        return (len(self.volumes) * self.samples_per_volume) // self.batch_size

    def epoch_plan(self, epoch: int) -> List[Tuple[int, Tuple[int, int, int]]]:
        """(volume index, patch origin) of every patch of ``epoch``, in order:
        volumes in a random order, ``samples_per_volume`` origins each, drawn
        uniformly from 0 .. shape - patch per axis."""
        gen = torch.Generator().manual_seed(self.seed + epoch)
        plan = []
        for idx in torch.randperm(len(self.volumes), generator=gen).tolist():
            highs = [s - p + 1 for s, p in zip(self.volumes[idx][0].shape[:3], self.patch_size)]
            for _ in range(self.samples_per_volume):
                origin = tuple(int(torch.randint(0, hi, (1,), generator=gen)) for hi in highs)
                plan.append((idx, origin))
        return plan

    def _crop(self, vol: torch.Tensor, origin: Sequence[int]) -> torch.Tensor:
        (x, y, z), (px, py, pz) = origin, self.patch_size
        return vol[x : x + px, y : y + py, z : z + pz]

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        plan = self.epoch_plan(self._epoch)
        self._epoch += 1
        for b in range(len(self)):  # drop_last: the leftover patches are not cut
            chunk = plan[b * self.batch_size : (b + 1) * self.batch_size]
            xs = torch.stack([self._crop(self.volumes[i][0], o) for i, o in chunk])
            ys = torch.stack([self._crop(self.volumes[i][1], o) for i, o in chunk])
            yield xs, ys
