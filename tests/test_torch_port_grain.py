"""The port's worker loader behind ``data_backend=grain``
(``data/grain_pipeline.py``): NDHWC f32 batches, the JAX
``GrainPatchDataset``'s length on the same config, each patch a crop of its
subject's transformed volume (the record's own generator replayed), every
subject ``samples_per_volume`` times an epoch, reshuffled, the same
batches from 0 and 2 worker processes, ``make_dataset``'s switch, and
``train.main`` with it."""

import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

pytest.importorskip("flax")  # the JAX package is this file's oracle: without it the file skips
from general_medical_image_segmentation_cnn_framework_tpu.data.grain_pipeline import (  # noqa: E402
    GrainPatchDataset,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import make_dataset  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.grain_pipeline import (  # noqa: E402
    WorkerPatchDataset,
)
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.pipeline import get_subjects, load_subject  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.transforms import build_transform  # noqa: E402
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D  # noqa: E402
from test_torch_port_train import _train_args  # noqa: E402


def _config(synthetic_dataset, *extra):
    return compose(_train_args(synthetic_dataset, "/nonexistent", "config.data_backend=grain",
                               "config.samples_per_volume=3", "config.batch_size=2", *extra), make_run_dir=False)


def test_batches_are_ndhwc_f32_and_the_length_is_jaxs(synthetic_dataset):
    cfg = _config(synthetic_dataset, "config.patch_size=8, 12, 16")
    ds = WorkerPatchDataset(cfg)
    assert len(ds) == len(GrainPatchDataset(cfg)) == 3 * 3 // 2 == 4  # the last partial batch dropped
    batches = list(ds)
    assert len(batches) == 4
    for x, y in batches:
        assert x.shape == (2, 8, 12, 16, 1) and y.shape == (2, 8, 12, 16, 1)
        assert x.dtype == y.dtype == torch.float32 and set(y.unique().tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("aug", [False, True])
def test_each_patch_is_a_crop_of_its_transformed_subject(synthetic_dataset, aug):
    """Record i of epoch e: the subject i // samples_per_volume through
    ``build_transform`` and the uniform origin, both drawn from the record's
    generator seeded with (seed, e, i); replayed here by hand."""
    cfg = _config(synthetic_dataset, f"config.aug={str(aug).lower()}")
    ds = WorkerPatchDataset(cfg)
    subjects = [load_subject(p) for p in get_subjects(cfg)]
    transform = build_transform(cfg, True)
    for epoch in range(2):
        order = ds.epoch_order(epoch)
        for b, (x, y) in enumerate(ds):
            for j, idx in enumerate(order[2 * b : 2 * b + 2]):
                rng = np.random.default_rng((0, epoch, int(idx)))
                subject = transform(subjects[idx // 3].copy(), rng)
                origin = [int(rng.integers(0, s - 16 + 1)) for s in subject.source.data.shape[1:]]
                sl = (0,) + tuple(slice(o, o + 16) for o in origin)
                np.testing.assert_array_equal(x[j, ..., 0].numpy(), subject.source.data[sl].astype(np.float32))
                np.testing.assert_array_equal(y[j, ..., 0].numpy(), subject.gt.data[sl].astype(np.float32))


def test_every_subject_samples_per_volume_times_and_reshuffled(synthetic_dataset):
    cfg = _config(synthetic_dataset, "config.samples_per_volume=4")
    ds = WorkerPatchDataset(cfg)
    orders = [ds.epoch_order(e) for e in range(2)]
    for order in orders:
        assert sorted(order.tolist()) == list(range(12))
        assert np.bincount(order // 4, minlength=3).tolist() == [4, 4, 4]
    assert orders[0].tolist() != orders[1].tolist()
    first, second = list(ds), list(ds)
    assert len(first) == len(second) == 6
    assert not all(torch.equal(a[0], b[0]) for a, b in zip(first, second))


def test_the_batches_do_not_depend_on_the_workers(synthetic_dataset):
    cfg = _config(synthetic_dataset)
    in_process = list(WorkerPatchDataset(cfg, worker_count=0))
    got = list(WorkerPatchDataset(cfg, worker_count=2))
    assert len(got) == len(in_process) == 4
    for (x0, y0), (x2, y2) in zip(in_process, got):
        assert torch.equal(x0, x2) and torch.equal(y0, y2)


def test_make_dataset_chooses_it_for_grain(synthetic_dataset):
    cfg = _config(synthetic_dataset, "config.grain_workers=2")
    ds = make_dataset(cfg)
    assert isinstance(ds, WorkerPatchDataset) and ds.worker_count == 2 and not ds.pin_memory


def test_train_main_with_the_grain_backend(synthetic_dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(port_train, "build_model", lambda config: UNet3D(1, 2, 4, init_type=config.init_type))
    out = port_train.main(_train_args(synthetic_dataset, tmp_path / "runs", "config.epochs=1",
                                      "config.data_backend=grain", "config.grain_workers=1"))
    (run,) = (tmp_path / "runs").glob("train-*/*")
    losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
              if line.startswith("Loss: ")]
    assert len(losses) == 1 and np.isfinite(losses).all() and np.isfinite(out["loss"])
