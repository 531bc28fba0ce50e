"""Segmentation colormap, numpy only: a fixed palette of visually distinct
RGB colours for link and part masks (a copy of the JAX package's
utils/colormap.py)."""

import numpy as np

# 24 distinct colors, [0, 1] RGB
COLORMAP = np.array([
    [0.894, 0.102, 0.110], [0.216, 0.494, 0.722], [0.302, 0.686, 0.290],
    [0.596, 0.306, 0.639], [1.000, 0.498, 0.000], [1.000, 1.000, 0.200],
    [0.651, 0.337, 0.157], [0.969, 0.506, 0.749], [0.600, 0.600, 0.600],
    [0.121, 0.471, 0.706], [0.682, 0.780, 0.910], [0.200, 0.627, 0.173],
    [0.698, 0.875, 0.541], [0.984, 0.604, 0.600], [0.890, 0.102, 0.110],
    [0.992, 0.749, 0.435], [1.000, 0.498, 0.000], [0.792, 0.698, 0.839],
    [0.416, 0.239, 0.604], [1.000, 1.000, 0.600], [0.694, 0.349, 0.157],
    [0.880, 0.880, 0.880], [0.737, 0.741, 0.133], [0.090, 0.745, 0.812],
], dtype=np.float32)


def color_for(index: int) -> np.ndarray:
    return COLORMAP[index % len(COLORMAP)]


def colorize_mask(mask: np.ndarray) -> np.ndarray:
    """(N,) int mask -> (N, 3) colors (negative ids -> gray)."""
    mask = np.asarray(mask)
    colors = COLORMAP[np.abs(mask) % len(COLORMAP)]
    colors[mask < 0] = [0.3, 0.3, 0.3]
    return colors
