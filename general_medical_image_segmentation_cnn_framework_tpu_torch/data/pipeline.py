"""Subject discovery and the inference tile grid: the JAX package's
host-side module, reused (it imports JAX only inside the training queue's
constructor, which the port does not use)."""

from general_medical_image_segmentation_cnn_framework_tpu.data.pipeline import get_subjects, grid_locations, load_subject  # noqa: F401
