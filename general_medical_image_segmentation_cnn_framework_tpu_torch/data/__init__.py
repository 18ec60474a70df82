"""Data layer: volume I/O, transforms, the host patch queue, the worker
loader and the device-resident patch sampler with its augmentation.

``io``, ``transforms`` and ``pipeline`` are the port's own copies of the JAX
package's host modules; ``device_prep`` and ``device_aug`` are the port's
counterparts of its device backend, ``grain_pipeline`` of its Grain loader.
"""

from __future__ import annotations

import logging

import torch


def make_dataset(config, is_train: bool = True, device: torch.device = torch.device("cpu")):
    """Training batches by ``config.data_backend``: ``device`` (volumes
    resident on ``device``, augmented there under ``aug``; falls back to
    ``threaded`` with a warning when the dataset exceeds
    ``device_dataset_gb``), ``threaded`` (host patch queue yielding numpy
    batches) or ``grain`` (``grain_workers`` worker processes yielding CPU
    tensors, pinned when ``device`` is a card)."""
    backend = getattr(config, "data_backend", "threaded")
    if backend == "grain":
        from .grain_pipeline import WorkerPatchDataset

        return WorkerPatchDataset(
            config, is_train=is_train, worker_count=int(getattr(config, "grain_workers", 0) or 0),
            pin_memory=torch.device(device).type == "cuda",
        )
    if backend == "device":
        from .device_prep import DeviceDatasetBudgetError, DevicePatchDataset

        try:
            return DevicePatchDataset(config, is_train=is_train, device=device)
        except DeviceDatasetBudgetError as e:
            logging.getLogger(__name__).warning("%s — falling back to the threaded backend", e)
    from .pipeline import PatchQueueDataset

    return PatchQueueDataset(config, is_train=is_train, process_index=0)
