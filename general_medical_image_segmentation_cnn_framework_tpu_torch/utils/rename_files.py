"""Offline prediction-file renamer.

The port's copy of the JAX package's ``utils/rename_files.py``: renames
``pred-NNNN.nii.gz`` outputs to ``NN.nii.gz`` (dataset-specific numbering,
offset configurable), as the reference's renamer does.

CLI: ``python -m general_medical_image_segmentation_cnn_framework_tpu_torch.utils.rename_files <pred_dir> [offset]``
"""

from __future__ import annotations

import re
import sys
from pathlib import Path


def rename_predictions(pred_dir, offset: int = 0) -> int:
    pred_dir = Path(pred_dir)
    pattern = re.compile(r"pred-(\d+)\.nii\.gz$")
    count = 0
    for path in sorted(pred_dir.iterdir()):
        m = pattern.match(path.name)
        if not m:
            continue
        new_name = f"{int(m.group(1)) + offset}.nii.gz"
        path.rename(pred_dir / new_name)
        count += 1
        print(f"{path.name} -> {new_name}")
    return count


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: rename_files <pred_dir> [offset]")
    rename_predictions(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 0)
