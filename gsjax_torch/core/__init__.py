"""Core math: quaternions, SH/SG appearance, camera transforms."""
