"""Model zoo of the port (UNet3D so far)."""

from .registry import build_model  # noqa: F401
