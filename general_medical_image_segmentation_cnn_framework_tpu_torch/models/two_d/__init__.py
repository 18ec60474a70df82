"""2-D networks of the port: they take [B, H, W, C] slices."""
