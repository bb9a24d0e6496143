"""Datasets: COLMAP and PLY files, scene readers, synthetic scenes."""
