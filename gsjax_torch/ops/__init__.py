"""Rendering operators: the tile rasterizer and its kernels."""
