"""Logger, progress bars and meters: the JAX package's module, reused."""

from general_medical_image_segmentation_cnn_framework_tpu.logging_utils import ProgressBars, get_logger, log_config  # noqa: F401
