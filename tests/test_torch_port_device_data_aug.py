"""The device backend with ``aug=true`` (``data/device_prep.py``): the
volumes stay raw on the device; each epoch every volume goes through
``data/device_aug.augment_pair`` at its true shape, in the epoch's volume
order, and its patches are cut from the result; ``train.main`` trains with
it. On the CPU, where the port runs the same tensor code as on the card."""

import numpy as np
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch import train as port_train
from general_medical_image_segmentation_cnn_framework_tpu_torch.config import compose
from general_medical_image_segmentation_cnn_framework_tpu_torch.data import make_dataset
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.device_aug import augment_pair
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.device_prep import DevicePatchDataset
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.pipeline import get_subjects, load_subject
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.unet3d import UNet3D


def _args(root, out, *extra):
    return [
        "config=unet", "config.platform=cpu", f"config.data_path={root}/train/source",
        f"config.gt_path={root}/train/label", f"config.output_dir={out}", "config.patch_size=8, 12, 16",
        "config.batch_size=4", "config.samples_per_volume=3", "config.precision=float32", "config.aug=true",
        "config.epochs_per_checkpoint=1000", *extra,
    ]


def test_volumes_stay_raw_and_each_patch_is_a_crop_of_the_augmented_volume(synthetic_dataset):
    cfg = compose(_args(synthetic_dataset, "/nonexistent"), make_run_dir=False)
    ds = make_dataset(cfg)
    assert isinstance(ds, DevicePatchDataset) and ds.aug and len(ds) == 2
    subjects = [load_subject(p) for p in get_subjects(cfg)]
    for (src, gt), subject in zip(ds.volumes, subjects):  # raw, not z-normalised
        np.testing.assert_array_equal(src[..., 0].numpy(), subject.source.data[0])
        np.testing.assert_array_equal(gt[..., 0].numpy(), subject.gt.data[0])
    epochs = []
    for epoch in range(2):
        plan = ds.epoch_plan(epoch)
        batches = list(ds)
        epochs.append(batches)
        # replay: the epoch's generator, the volumes in the plan's order, each augmented once
        gen, augmented = ds.aug_generator(epoch), {}
        for idx, _ in plan[: 2 * 4]:
            if idx not in augmented:
                src, gt = ds.volumes[idx]
                s, g = augment_pair(gen, src.movedim(-1, 0), gt.movedim(-1, 0))
                augmented[idx] = (s.movedim(0, -1), g.movedim(0, -1))
        for b, (x, y) in enumerate(batches):
            assert x.shape == y.shape == (4, 8, 12, 16, 1) and x.dtype == torch.float32
            assert set(y.unique().tolist()) <= {0.0, 1.0}
            for j, (idx, (o0, o1, o2)) in enumerate(plan[4 * b : 4 * b + 4]):
                sl = (slice(o0, o0 + 8), slice(o1, o1 + 12), slice(o2, o2 + 16))
                assert torch.equal(x[j], augmented[idx][0][sl]) and torch.equal(y[j], augmented[idx][1][sl])
    assert not torch.equal(epochs[0][0][0], epochs[1][0][0])


def test_train_main_with_device_augmentation(synthetic_dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(port_train, "build_model", lambda config: UNet3D(1, 2, 4, init_type=config.init_type))
    out = port_train.main(_args(synthetic_dataset, tmp_path / "runs", "config.patch_size=16, 16, 16",
                                "config.batch_size=2", "config.epochs=2"))
    (run,) = (tmp_path / "runs").glob("train-*/*")
    losses = [float(line.split(":", 1)[1]) for line in (run / "train.log").read_text().splitlines()
              if line.startswith("Loss: ")]
    assert len(losses) == 8 and np.isfinite(losses).all() and np.isfinite(out["loss"])
