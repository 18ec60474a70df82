"""3-D networks of the port."""
