"""Data layer: volume I/O, transforms, the host patch queue and the
device-resident patch sampler.

``io``, ``transforms`` and ``pipeline`` are the port's own copies of the JAX
package's host modules; ``device_prep`` is the port's counterpart of its
device backend.
"""

from __future__ import annotations

import logging

import torch


def make_dataset(config, is_train: bool = True, device: torch.device = torch.device("cpu")):
    """Training batches by ``config.data_backend``: ``device`` (volumes
    resident on ``device``; falls back to ``threaded`` with a warning when the
    dataset exceeds ``device_dataset_gb``) or ``threaded`` (host patch queue
    yielding numpy batches). ``grain`` is not ported."""
    backend = getattr(config, "data_backend", "threaded")
    if backend == "grain":
        raise NotImplementedError(
            "data_backend=grain (multiprocess loading) is not ported to PyTorch yet: "
            "ROADMAP queue 1 item 9. Use data_backend=device or threaded."
        )
    if backend == "device":
        from .device_prep import DeviceDatasetBudgetError, DevicePatchDataset

        try:
            return DevicePatchDataset(config, is_train=is_train, device=device)
        except DeviceDatasetBudgetError as e:
            logging.getLogger(__name__).warning("%s — falling back to the threaded backend", e)
    from .pipeline import PatchQueueDataset

    return PatchQueueDataset(config, is_train=is_train, process_index=0)
