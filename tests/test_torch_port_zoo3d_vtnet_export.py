"""VT-UNet's crop program through ``torch.export`` (``serving.export_predictor``)
on the CPU: the sliding window's program at a 32^3 volume (one 32^3 tile;
VT-UNet at embed 12, window 4, seeded weights) exported, saved and loaded,
gives the Predictor's mask exactly. Its roll, window partition, padding
and shift masks are made inside the program (the masks from constant id
grids). ``chip_smoke.py`` [15] exports it at full width on the card."""

import numpy as np
import torch
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread a module)

from general_medical_image_segmentation_cnn_framework_tpu_torch.config import ConfigDict
from general_medical_image_segmentation_cnn_framework_tpu_torch.data.transforms import ZNormalization
from general_medical_image_segmentation_cnn_framework_tpu_torch.models.three_d.vtnet import VTUNet
from general_medical_image_segmentation_cnn_framework_tpu_torch.serving import (
    Predictor, export_predictor, load_exported_predictor,
)


def test_exported_crop_program_gives_the_predictors_mask():
    model = VTUNet(2, 1, embed_dim=12, win_size=4, seed=3)
    with torch.no_grad():  # bias tables far from their 0.02 init, so that the masks and slices matter
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(4))
    params = model.state_dict()
    cfg = ConfigDict(network="vtnet", in_classes=1, out_classes=2, patch_size=(32, 32, 32),
                     patch_overlap=(8, 8, 8), batch_size=1, precision="float32", platform="cpu")
    predictor = Predictor(cfg, model=model, params=params)
    raw = np.random.default_rng(25).normal(2.0, 1.5, size=(1, 32, 32, 32)).astype(np.float32)
    mask = predictor.predict_array(raw)
    exported = load_exported_predictor(export_predictor(predictor, (32, 32, 32)))
    got = exported(params, ZNormalization().normalize_array(raw))
    assert exported.meta["whole_volume"] is False and got.shape == mask.shape == (1, 32, 32, 32)
    assert 0 < mask.mean() < 1
    np.testing.assert_array_equal(got, mask)
