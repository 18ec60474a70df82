"""PyTorch/CUDA port of the medical image segmentation framework.

A second package beside the JAX package
``general_medical_image_segmentation_cnn_framework_tpu``, which stays the
reference the port is tested against. Module paths mirror the JAX
package's. Public tensors are channels-last (NDHWC), as there.

Ported so far: the UNet3D sliding-window predict path (``predict``), with
every eval ConvBlock running the hand-written CUDA kernel
``ops.conv3d_bn_relu`` on a CUDA card. The host layers (config, NIfTI/MHD
I/O, transforms, subject discovery, tile grid, logging) are the JAX
package's own JAX-free modules, imported through thin modules here.
"""

__version__ = "0.1.0"
