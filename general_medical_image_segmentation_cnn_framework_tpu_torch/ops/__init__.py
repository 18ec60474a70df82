"""Kernels and device-side array programs of the port."""
