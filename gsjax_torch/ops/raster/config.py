"""Rasterizer configuration (port of `gsjax/ops/raster/config.py`).

Field for field the same as gsjax's `RasterConfig`, so call sites match.
Fields that only shape gsjax's static XLA/Mosaic buffers are kept for
signature parity but bound nothing here: the port sizes its pair buffers
from the real pair count (`pair_capacity`, `live_capacity`, `align`), and
`tile_batch` / `chunk` only bound the memory of the plain-PyTorch blend.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    # Tile geometry: 32x32 keeps the binning identical to gsjax; the CUDA
    # blend runs each tile as four 16x16 thread blocks.
    tile: int = 32
    # Gaussians per step of the plain-PyTorch blend (render_ref).
    chunk: int = 64
    # Tiles per batch of the plain-PyTorch blend (bounds its peak memory).
    tile_batch: int = 128

    # gsjax's static pair-buffer capacities; not a limit in the port.
    pair_capacity: int = 1 << 20
    live_capacity: int | None = None
    # Cap on gaussians blended per tile (each tile's list is clamped here).
    max_per_tile: int = 1 << 12
    # gsjax's tile-slice alignment; the port's pair lists are dense.
    align: int = 128
    # Blend backend: "cuda" = the hand-written kernel (CUDA tensors only),
    # "torch" = the plain-PyTorch twin, "auto" = kernel for CUDA tensors and
    # twin for CPU tensors.
    backend: str = "auto"

    sh_degree: int = 3
    sg_degree: int = 0

    # Mip-Splatting 2D screen-space dilation (render_forward.cu:191-196).
    kernel_size: float = 0.0
    scale_modifier: float = 1.0

    # RaDe-GS median-depth search (config.h:27-39).
    require_depth: bool = True
    split: int = 8
    split_iterations: int = 5
    sample_range: float = 0.4
    min_transmittance: float = 0.45
    near_plane: float = 0.2

    # Blend-loop thresholds (render_forward.cu:487-500).
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4

    def grid(self, width: int, height: int) -> tuple[int, int]:
        tx = -(-width // self.tile)
        ty = -(-height // self.tile)
        return tx, ty

    @property
    def pixels_per_tile(self) -> int:
        return self.tile * self.tile
