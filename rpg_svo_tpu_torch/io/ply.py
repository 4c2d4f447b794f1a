"""ASCII PLY point-cloud export.

Port of ``rpg_svo_tpu/io/ply.py`` (the reference's depth-filter test writes
converged seeds as a .ply cloud, svo/test/test_depth_filter.cpp:174-194):
the map's points, read to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """Write (N, 3) float points (and optional (N, 3) uint8 colours)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {pts.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in pts:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        else:
            cols = np.asarray(colors, dtype=np.int64).reshape(-1, 3)
            for p, c in zip(pts, cols):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{c[0]} {c[1]} {c[2]}\n")


def map_points_ply(path: str, svomap) -> int:
    """Export the map's active points (a MapState); returns their count."""
    pos = svomap.pt.pos.detach().cpu().numpy()
    ok = svomap.pt.active.detach().cpu().numpy()
    write_ply(path, pos[ok])
    return int(ok.sum())
