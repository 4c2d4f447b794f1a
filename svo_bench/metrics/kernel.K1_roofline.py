"""K1 (``csrc/tile_gather.cu``) against its roofline: the time the bytes
these launches need would take at the H100's published 3.35 TB/s, over
the profiler's device time of the same launches.  Bytes: each tile
element read once and written once (4 bytes each way), as
``chip_smoke.py``'s K1 count; the elements of a launch come from its grid
(one thread per element, ``kThreads`` = 256 per block, grid.y streams),
which gives them to within one block: the count takes whole blocks, at
most 255 elements over a launch's own.  The requests read and the
origins written (20 bytes a tile, which the grid does not give) are left
out.  At the shape chip_smoke.py counts (17x17x256) the tile part is
exact.  The launches are those of the short segment profiled for their
grids after the window (``trace.GRID_STEPS`` steps)."""

NAME = "kernel.K1_roofline"
UNIT = "%"
LAYER = "kernels, K1 csrc/tile_gather.cu"
MOVES = "frames_per_s"
HBM_BYTES_PER_S = 3.35e12
K1_THREADS = 256


def k1_bytes(grid) -> float:
    """Bytes of one K1 launch of the given grid (x, y, z)."""
    return 2 * 4 * grid[0] * K1_THREADS * grid[1]


def read(rec):
    p = rec.get("grids")
    if not p:
        return None
    launches = [(d, g) for n, _, d, g in p["device"]
                if "tile_gather_kernel" in n]
    if not launches or any(g is None for _, g in launches):
        return None
    bound_ns = sum(k1_bytes(g) for _, g in launches) / HBM_BYTES_PER_S * 1e9
    return 100.0 * bound_ns / sum(d for d, _ in launches)
