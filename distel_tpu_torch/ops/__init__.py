"""Bit-packed boolean linear algebra and its CUDA kernels."""
