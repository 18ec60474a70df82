"""NIfTI/MHD volume I/O: the JAX package's pure-numpy module, reused."""

from general_medical_image_segmentation_cnn_framework_tpu.data.io import Volume, read_volume, write_nifti, write_volume  # noqa: F401
