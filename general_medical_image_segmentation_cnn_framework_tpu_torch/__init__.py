"""PyTorch/CUDA port of the medical image segmentation framework.

A second package beside the JAX package
``general_medical_image_segmentation_cnn_framework_tpu``, which stays the
reference the port is tested against; the port imports nothing of it.
Module paths mirror the JAX package's. Public tensors are channels-last
(NDHWC), as there.

Ported so far: training (``train``), predict (``predict``) and serving
(``serving``: a resident Predictor, directory-watch serving, the predict
program exported with ``torch.export``) of UNet3D and UNet2D, and the
offline tools (``utils``). On a CUDA card every k3 s1 conv runs
hand-written kernels: the forward and its input gradient
``ops.conv3d_bn_relu``, the weight gradient ``ops.conv3d_wgrad``; the
BCE + dice loss/metric and its gradient run ``ops.fused_bce_dice``. The
host layers (config, NIfTI/MHD I/O, transforms, subject discovery, tile
grid, logging) are the port's own copies of the JAX package's modules.
"""

__version__ = "0.1.0"
