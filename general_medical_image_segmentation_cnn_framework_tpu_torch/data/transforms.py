"""Host transforms: the JAX package's numpy/scipy module, reused."""

from general_medical_image_segmentation_cnn_framework_tpu.data.transforms import ZNormalization  # noqa: F401
