"""Model zoo of the port: UNet3D, UNet2D and nine 3-D networks (``registry``)."""

from .registry import build_model, is_2d, make_forward, pad_multiple  # noqa: F401
