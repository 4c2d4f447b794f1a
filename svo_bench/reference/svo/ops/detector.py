"""FAST-10 corners, Shi-Tomasi scores, NMS and the per-cell best corner.

Port of ``rpg_svo_tpu/ops/detector.py`` (FastDetector,
svo/src/feature_detection.cpp:66-114), used to seed the first frame:
dense whole-image tensor math, one best corner per grid cell across the
pyramid levels, as a static (n_cells,) table.

The per-cell maximum is a scatter-max over cell ids; the winner is the
lowest flat index whose score reaches the cell maximum less the JAX
package's tolerance (1e-4 relative), as there.  Box sums use float64
integral images: float32 ones lose ~1e-3 of a box sum to cancellation, and
their rounding depends on the scan order, which differs between devices.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from svo_bench.reference.svo.core import graphed

# Bresenham circle of radius 3, (dx, dy), clockwise from 12 o'clock.
FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def fast_corner_mask(img: torch.Tensor, threshold: float = 20.0,
                     arc_length: int = 10) -> torch.Tensor:
    """Dense FAST segment test: >= arc_length contiguous circle pixels all
    brighter than I+t or all darker than I-t; 3 px border excluded."""
    hi = img + threshold
    lo = img - threshold
    bits_b = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    bits_d = torch.zeros_like(bits_b)
    for i, (dx, dy) in enumerate(FAST_OFFSETS):
        s = torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
        bits_b = bits_b | ((s > hi).to(torch.int32) << i)
        bits_d = bits_d | ((s < lo).to(torch.int32) << i)

    def has_run(m):
        for _ in range(arc_length - 1):
            m = m & (((m << 1) | (m >> 15)) & 0xFFFF)
        return m != 0

    corner = has_run(bits_b) | has_run(bits_d)
    H, W = img.shape
    inside = torch.zeros_like(corner)
    inside[3:H - 3, 3:W - 3].fill_(True)
    return corner & inside


def _box_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Sum over a size x size window (offset like the reference's halfbox
    loop), zero padded, same shape."""
    half = size // 2
    pad = F.pad(x.to(torch.float64), (half + 1, half, half + 1, half))
    ii = torch.cumsum(torch.cumsum(pad, dim=0), dim=1)
    H, W = x.shape
    a = ii[size:, size:][:H, :W]
    b = ii[:-size, size:][:H, :W]
    c = ii[size:, :-size][:H, :W]
    d = ii[:-size, :-size][:H, :W]
    return (a - b - c + d).to(torch.float32)


def shi_tomasi_score(img: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Dense min-eigenvalue score (vikit shiTomasiScore: central
    differences over an 8x8 box, normalized by 2 * box area)."""
    dx = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1)) * 2.0
    dy = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0)) * 2.0
    box = 2 * halfbox
    n = 2.0 * box * box
    dxx = _box_sum(dx * dx, box) / n
    dyy = _box_sum(dy * dy, box) / n
    dxy = _box_sum(dx * dy, box) / n
    tr = dxx + dyy
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * (dxx * dyy - dxy * dxy),
                                  min=0.0))
    return 0.5 * (tr - disc)


def nonmax_3x3(score: torch.Tensor) -> torch.Tensor:
    """True where score is >= all 8 neighbours (wrapping, as jnp.roll)."""
    neigh = [torch.roll(score, shifts=(dy, dx), dims=(0, 1))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dx or dy]
    return score >= torch.stack(neigh).amax(dim=0)


def grid_dims(width: int, height: int, cell_size: int) -> Tuple[int, int]:
    return (-(-width // cell_size), -(-height // cell_size))


def cell_index(px: torch.Tensor, cell_size: int, ncx: int,
               ncy: int) -> torch.Tensor:
    """Level-0 pixel coords (..., 2) -> flat grid cell index."""
    cx = torch.clamp(torch.div(px[..., 0], cell_size, rounding_mode="floor")
                     .to(torch.int32), 0, ncx - 1)
    cy = torch.clamp(torch.div(px[..., 1], cell_size, rounding_mode="floor")
                     .to(torch.int32), 0, ncy - 1)
    return cy * ncx + cx


@graphed.jit(static_argnames=("cell_size", "threshold", "arc_length"))
def detect_features(pyramid: Sequence[torch.Tensor], occupied: torch.Tensor,
                    cell_size: int, threshold: float = 20.0,
                    arc_length: int = 10):
    """FAST + Shi-Tomasi + NMS + best corner per cell across the levels.

    Returns a dict of per-cell tensors: px (C, 2) level-0 float coords,
    level (C,) int32, score (C,) float32, valid (C,) bool."""
    H0, W0 = pyramid[0].shape
    dev = pyramid[0].device
    ncx, ncy = grid_dims(W0, H0, cell_size)
    C = ncx * ncy
    ninf = float("-inf")
    best_score = torch.full((C,), ninf, device=dev)
    best_px = torch.zeros((C, 2), device=dev)
    best_level = torch.zeros((C,), dtype=torch.int32, device=dev)
    for level, img in enumerate(pyramid):
        H, W = img.shape
        corner = fast_corner_mask(img, threshold, arc_length)
        score = shi_tomasi_score(img)
        keep = corner & nonmax_3x3(
            torch.where(corner, score, torch.full_like(score, ninf)))
        masked = torch.where(keep, score, torch.full_like(score, ninf))
        scale = 2 ** level
        cy = torch.clamp(torch.arange(H, device=dev) * scale // cell_size,
                         max=ncy - 1)
        cx = torch.clamp(torch.arange(W, device=dev) * scale // cell_size,
                         max=ncx - 1)
        cell = (cy[:, None] * ncx + cx[None, :]).reshape(-1)
        # cells with no pixel at this level stay -inf
        cmax = torch.full((C,), ninf, device=dev).scatter_reduce(
            0, cell, masked.reshape(-1), reduce="amax", include_self=True)
        full = cmax[cell]
        full = torch.clamp(full, min=-3e38)
        full = full - torch.clamp(1e-4 * torch.abs(full), min=1e-6)
        flat = masked.reshape(-1)
        is_best = (flat >= full) & torch.isfinite(flat)
        idx = torch.arange(H * W, device=dev)
        win = torch.full((C,), H * W, device=dev).scatter_reduce(
            0, cell, torch.where(is_best, idx, torch.full_like(idx, H * W)),
            reduce="amin", include_self=True)
        has = win < H * W
        wi = torch.clamp(win, 0, H * W - 1)
        px0 = torch.stack([(wi % W).to(torch.float32),
                           (wi // W).to(torch.float32)], dim=-1) * scale
        better = has & (cmax > best_score)
        best_px = torch.where(better[:, None], px0, best_px)
        best_level = torch.where(better, torch.full_like(best_level, level),
                                 best_level)
        best_score = torch.where(better, cmax, best_score)
    valid = torch.isfinite(best_score) & (best_score > 0) & ~occupied
    return {"px": best_px, "level": best_level,
            "score": torch.where(valid, best_score,
                                 torch.zeros_like(best_score)),
            "valid": valid}


def select_top_k(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Indices of the k best valid entries (padded with -1); among equal
    scores the lower index comes first, as lax.top_k orders them."""
    masked = torch.where(valid, scores, torch.full_like(scores,
                                                        float("-inf")))
    vals, idx = torch.sort(masked, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    return torch.where(torch.isfinite(vals), idx.to(torch.int32),
                       torch.full_like(idx, -1, dtype=torch.int32))
