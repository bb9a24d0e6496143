"""Evaluation: LPIPS, the DTU chamfer protocol and the Tanks-and-Temples F1."""
