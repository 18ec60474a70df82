"""Device-side patch sampling: the training volumes live on the device and
every epoch's patches are cropped there.

The counterpart of the JAX package's ``data/device_prep.py``
(``data_backend=device``, the default): each volume crosses to the device
once; each epoch visits the volumes in a random order and cuts
``samples_per_volume`` uniform random patches from each, batches of
``batch_size`` with the last partial batch dropped. The order and the patch
origins come from a ``torch.Generator`` seeded with ``config.seed`` +
epoch, so a run is reproducible; they are not the JAX package's random
numbers.

* aug=false: each volume is z-normalised once, on the device.
* aug=true: the volumes stay raw on the device; each epoch every volume is
  augmented there at its true shape (``data/device_aug.augment_pair``, the
  tio stack), in the epoch's volume order, just before its patches are
  cut. The draws come from ``aug_generator(epoch)``, a generator on the
  device seeded with ``config.seed`` + epoch.

The whole dataset must fit in ``config.device_dataset_gb``; above it the
constructor raises ``DeviceDatasetBudgetError`` before any transfer and
``data.make_dataset`` falls back to the threaded host pipeline.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .device_aug import aug_generator, augment_pair, znormalize
from .pipeline import get_subjects, load_subject


class DeviceDatasetBudgetError(RuntimeError):
    """Dataset too large for the device-resident backend (device_dataset_gb)."""


class DevicePatchDataset:
    """Iterable of (x [B, *patch, C], y [B, *patch, 1]) f32 batches on
    ``device``; tio.Queue sampler semantics."""

    def __init__(self, config, is_train: bool = True, device: torch.device = torch.device("cpu")):
        self.aug = bool(getattr(config, "aug", False)) and is_train
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
        self.volumes: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for src, gt in host:
            src = torch.from_numpy(src).to(self.device)
            self.volumes.append((src if self.aug else znormalize(src), torch.from_numpy(gt).to(self.device)))

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

    def aug_generator(self, epoch: int) -> torch.Generator:
        """The augmentation's generator of ``epoch``, on the device."""
        return aug_generator(self.seed, epoch, self.device)

    def augmented(self, idx: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """Volume ``idx`` through ``augment_pair`` at its true shape, channels last."""
        src, gt = self.volumes[idx]
        src, gt = augment_pair(generator, src.movedim(-1, 0), gt.movedim(-1, 0))
        return src.movedim(0, -1), gt.movedim(0, -1)

    def _crop(self, vol: torch.Tensor, origin: Sequence[int]) -> torch.Tensor:
        (x, y, z), (px, py, pz) = origin, self.patch_size
        return vol[x : x + px, y : y + py, z : z + pz]

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        plan = self.epoch_plan(self._epoch)
        generator = self.aug_generator(self._epoch) if self.aug else None
        self._epoch += 1
        live = {}  # the volumes this batch crops: augmented once each, in the plan's order
        for b in range(len(self)):  # drop_last: the leftover patches are not cut
            chunk = plan[b * self.batch_size : (b + 1) * self.batch_size]
            if self.aug:
                kept = {}
                for i, _ in chunk:
                    if i not in kept:
                        kept[i] = live[i] if i in live else self.augmented(i, generator)
                live = kept
            else:
                live = self.volumes
            xs = torch.stack([self._crop(live[i][0], o) for i, o in chunk])
            ys = torch.stack([self._crop(live[i][1], o) for i, o in chunk])
            yield xs, ys
