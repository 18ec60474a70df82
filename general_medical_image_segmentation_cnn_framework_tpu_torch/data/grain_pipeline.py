"""The worker-process patch loader behind ``data_backend=grain``.

The counterpart of the JAX package's ``data/grain_pipeline.py`` (a Grain
``RandomAccessDataSource`` of (subject, sample) records, a
``RandomMapTransform`` that loads, transforms and crops, batched and
prefetched by Grain's multiprocess ``DataLoader``), on a
``torch.utils.data.DataLoader`` with ``config.grain_workers`` worker
processes; it imports no ``grain``.

Same sampler semantics as the reference's tio.Queue(samples_per_volume)
(reference dataloader.py:52-67): an epoch is subjects x samples_per_volume
records, shuffled by ``seed + epoch``, each one uniform random patch of its
subject's transformed volume (``build_transform(config, is_train)``),
batches of ``batch_size`` with the last partial batch dropped. Each record
draws from its own ``np.random.Generator`` seeded with (seed, epoch,
index), as Grain hands each record its own, so the batches do not depend on
the number of workers. A worker loads each subject it needs once an epoch
(the JAX ``_cache``) and returns numpy arrays: it touches no CUDA state,
and the workers are spawned, never forked from a process that holds a
card. With ``pin_memory`` the batches arrive in pinned host memory.

One process reads every record: nothing is sharded across processes (the
JAX module shards by JAX process, ``ShardByJaxProcess``) until the port
has multi-process training (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from .pipeline import get_subjects, load_subject
from .transforms import Subject, Transform, build_transform


class _PatchRecords(Dataset):
    """Map-style dataset of (epoch, index) records: index // samples_per_volume
    is the subject; each returns one (x, y) patch, channels last, f32."""

    def __init__(self, pairs, samples_per_volume: int, patch_size, transform: Transform, seed: int):
        self.pairs = pairs
        self.samples_per_volume = samples_per_volume
        self.patch_size = tuple(patch_size)
        self.transform = transform
        self.seed = seed
        self._cache: Dict[int, Subject] = {}

    def __len__(self) -> int:
        return len(self.pairs) * self.samples_per_volume

    def __getitem__(self, record: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
        epoch, idx = record
        rng = np.random.default_rng((self.seed, epoch, idx))
        subject_idx = idx // self.samples_per_volume
        if subject_idx not in self._cache:
            self._cache[subject_idx] = load_subject(self.pairs[subject_idx])
        subject = self.transform(self._cache[subject_idx].copy(), rng)
        src, gt = subject.source.data, subject.gt.data
        origin = [int(rng.integers(0, s - p + 1)) for s, p in zip(src.shape[1:], self.patch_size)]
        sl = (slice(None),) + tuple(slice(o, o + p) for o, p in zip(origin, self.patch_size))
        x = np.ascontiguousarray(np.moveaxis(src[sl], 0, -1), dtype=np.float32)
        y = np.ascontiguousarray(np.moveaxis(gt[sl], 0, -1), dtype=np.float32)
        return x, y


class WorkerPatchDataset:
    """Iterable of (x [B, *patch, C], y [B, *patch, 1]) f32 CPU batches from
    ``worker_count`` worker processes (0: in this process)."""

    def __init__(self, config, is_train: bool = True, worker_count: int = 0, pin_memory: bool = False):
        pairs = get_subjects(config)
        if not pairs:
            raise FileNotFoundError(f"no .nii.gz pairs found under {config.data_path} / {config.gt_path}")
        self.batch_size = int(config.batch_size)
        self.seed = int(getattr(config, "seed", 0) or 0)
        self.worker_count = int(worker_count)
        self.pin_memory = pin_memory
        self.records = _PatchRecords(
            pairs, int(getattr(config, "samples_per_volume", 10)), config.patch_size,
            build_transform(config, is_train), self.seed,
        )
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.records) // self.batch_size

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The record indices of ``epoch`` in the order they are batched."""
        return np.random.default_rng(self.seed + epoch).permutation(len(self.records))

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        epoch = self._epoch
        self._epoch += 1
        loader = DataLoader(
            self.records, batch_size=self.batch_size, drop_last=True,
            sampler=[(epoch, int(i)) for i in self.epoch_order(epoch)],
            num_workers=self.worker_count, pin_memory=self.pin_memory,
            multiprocessing_context="spawn" if self.worker_count > 0 else None,
        )
        batches = iter(loader)
        try:
            yield from batches
        finally:
            del batches  # stops the workers now, also when the caller stops early
