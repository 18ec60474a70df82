"""Offline MHD -> NIfTI batch converter.

The port's copy of the JAX package's ``utils/trans2nii.py``: converts every
``*.mhd`` under the input dir to ``.nii.gz`` in the output dir, keeping the
affine, as the reference's ``convert_mhd_to_nii`` does.

CLI: ``python -m general_medical_image_segmentation_cnn_framework_tpu_torch.utils.trans2nii <input_dir> <output_dir>``
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..data.io import read_mhd, write_nifti


def convert_mhd_to_nii(input_dir, output_dir) -> int:
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    for mhd_path in sorted(input_dir.glob("*.mhd")):
        volume = read_mhd(mhd_path)
        out_path = output_dir / (mhd_path.stem + ".nii.gz")
        write_nifti(out_path, volume)
        count += 1
        print(f"{mhd_path} -> {out_path}")
    return count


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit("usage: trans2nii <input_dir> <output_dir>")
    convert_mhd_to_nii(sys.argv[1], sys.argv[2])
