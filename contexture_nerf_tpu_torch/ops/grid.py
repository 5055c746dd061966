"""Zero123++ 3x2 grid packing, column-major tile order: column 0 holds
views 0, 1, 2 (rows 0..2), column 1 views 3, 4, 5.

Counterpart of contexture_nerf_tpu/ops/grid.py.
"""

from __future__ import annotations

import torch

ROWS, COLS = 3, 2


def merge_6_to_grid(components: torch.Tensor) -> torch.Tensor:
    """(6, C, t, t) -> (1, C, 3t, 2t)."""
    n, C, t, _ = components.shape
    if n != ROWS * COLS:
        raise ValueError(f"expected 6 tiles, got {n}")
    x = components.reshape(COLS, ROWS, C, t, t).permute(2, 1, 3, 0, 4)
    return x.reshape(1, C, ROWS * t, COLS * t)


def split_grid_to_6(grid: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(1, C, 3t, 2t) -> (6, C, t, t)."""
    _, C, H, W = grid.shape
    t = tile_size
    if H != ROWS * t or W != COLS * t:
        raise ValueError(f"grid {H}x{W} is not 3x2 tiles of {t}")
    x = grid.reshape(C, ROWS, t, COLS, t).permute(3, 1, 0, 2, 4)
    return x.reshape(ROWS * COLS, C, t, t)
