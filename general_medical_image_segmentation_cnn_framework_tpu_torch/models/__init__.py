"""Model zoo of the port (UNet3D and UNet2D so far)."""

from .registry import build_model, is_2d, make_forward, pad_multiple  # noqa: F401
