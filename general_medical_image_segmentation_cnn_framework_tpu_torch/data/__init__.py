"""Data layer: the JAX package's JAX-free host modules, reused as they are."""
