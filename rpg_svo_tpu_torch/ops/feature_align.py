"""Subpixel feature alignment (batched inverse-compositional KLT).

Port of ``rpg_svo_tpu/ops/feature_align.py`` as the reprojector runs it
(feature_alignment::align2D / align1D, svo/src/feature_alignment.cpp):
8x8 patch with gradients from a 10x10 bordered reference patch, estimated
(u, v, mean offset) for 2-D items and (step along a direction, mean offset)
for 1-D items, fixed Hessians, 0.03 px convergence test.

Each item's current-image window is sampled from one 17x17 tile gathered
around its start (kernel K1 on the card) with the 4-tap Catmull-Rom
interpolant in every iteration (the JAX package's r5 default: 10 cubic
iterations of 10).  Taps are computed directly; the one-hot selection
contractions of the JAX package are TPU layout work.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rpg_svo_tpu_torch.geometry.linalg import inv2x2, inv3x3
from rpg_svo_tpu_torch.ops.patches import catmull_rom_weights

HALFPATCH = 4
PATCH = 2 * HALFPATCH          # 8
BORDERED = PATCH + 2           # 10
CONV_EPS = 0.03 * 0.03
SLACK = 4
TILE = PATCH + 1 + 2 * SLACK   # 17


def _gather_tile(cur_pad, level: torch.Tensor, px_init: torch.Tensor):
    """(base (N, 2) float tile origin, tiles (N, TILE, TILE)); the origin
    is clamped into the level, so tiles are always fully backed."""
    from rpg_svo_tpu_torch.ops.tiles import gather_tiles
    base = torch.floor(px_init).to(torch.int32) - HALFPATCH - SLACK
    vals, x0c, y0c = gather_tiles(cur_pad, level, base[:, 0], base[:, 1],
                                  TILE, TILE)
    return torch.stack([x0c, y0c], dim=-1).to(torch.float32), vals


def _window_cubic(tile: torch.Tensor, o: torch.Tensor):
    """Catmull-Rom 8x8 window at float offset o (N, 2) from the tiles:
    (cur (N, 64) row-major, in_bounds (N,)).  Interpolates along y first,
    then along x, as the reference's selection contractions."""
    N = tile.shape[0]
    oi = torch.floor(o)
    w = o - oi
    oi = oi.to(torch.int64)
    lo, hi = 1, TILE - PATCH - 2
    inb = (oi[:, 0] >= lo) & (oi[:, 1] >= lo) \
        & (oi[:, 0] <= hi) & (oi[:, 1] <= hi)
    ox = torch.clamp(oi[:, 0], lo, hi) - 1
    oy = torch.clamp(oi[:, 1], lo, hi) - 1
    R = PATCH + 3                                  # taps -1 .. PATCH+1
    r = torch.arange(R, device=tile.device)
    idx = (oy[:, None, None] + r[None, :, None]) * TILE \
        + ox[:, None, None] + r[None, None, :]
    reg = torch.gather(tile.reshape(N, -1), 1, idx.reshape(N, -1)) \
        .reshape(N, R, R)
    wy = catmull_rom_weights(w[:, 1])
    wx = catmull_rom_weights(w[:, 0])
    rows = None
    for k, wk in enumerate(wy):
        term = wk[:, None, None] * reg[:, k: k + PATCH, :]
        rows = term if rows is None else rows + term
    cur = None
    for k, wk in enumerate(wx):
        term = wk[:, None, None] * rows[:, :, k: k + PATCH]
        cur = term if cur is None else cur + term
    return cur.reshape(N, PATCH * PATCH), inb


def _border_gradients(patch_b: torch.Tensor):
    pb = patch_b.reshape(-1, BORDERED, BORDERED)
    inner = pb[:, 1:-1, 1:-1]
    dx = 0.5 * (pb[:, 1:-1, 2:] - pb[:, 1:-1, :-2])
    dy = 0.5 * (pb[:, 2:, 1:-1] - pb[:, :-2, 1:-1])
    n = PATCH * PATCH
    return inner.reshape(-1, n), dx.reshape(-1, n), dy.reshape(-1, n)


def align_features(cur_pad, ref_patch_border: torch.Tensor,
                   px_init: torch.Tensor, valid: torch.Tensor,
                   n_iter: int = 10, level: torch.Tensor | None = None,
                   direction: torch.Tensor | None = None,
                   is_1d: torch.Tensor | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched subpixel refinement at per-item pyramid ``level`` of the
    padded current pyramid; px in level coords.  Returns (px, converged).

    Converged items keep iterating (the reference breaks at the first
    sub-0.03 px update); ``converged`` keeps the reference's test while the
    position settles at the GN fixed point, and items whose window leaves
    the tile freeze."""
    N = px_init.shape[0]
    dev = px_init.device
    if level is None:
        level = torch.zeros((N,), dtype=torch.int32, device=dev)
    if direction is None:
        direction = torch.zeros((N, 2), device=dev)
        direction[:, 0] = 1.0
    if is_1d is None:
        is_1d = torch.zeros((N,), dtype=torch.bool, device=dev)
    ref, dx, dy = _border_gradients(ref_patch_border)
    ones = torch.ones_like(dx)
    J2 = torch.stack([dx, dy, ones], dim=-1)              # (N, 64, 3)
    H2 = torch.sum(J2[:, :, :, None] * J2[:, :, None, :], dim=1)
    H2inv = inv3x3(H2 + 1e-9 * torch.eye(3, device=dev))
    dd = dx * direction[:, None, 0] + dy * direction[:, None, 1]
    J1 = torch.stack([dd, ones], dim=-1)                   # (N, 64, 2)
    H1 = torch.sum(J1[:, :, :, None] * J1[:, :, None, :], dim=1)
    H1inv = inv2x2(H1 + 1e-9 * torch.eye(2, device=dev))

    base, tile = _gather_tile(cur_pad, level, px_init)
    uvm = torch.cat([px_init, torch.zeros_like(px_init[:, :1])], dim=-1)
    conv = torch.zeros_like(valid)
    for _ in range(n_iter):
        cur, in_img = _window_cubic(tile, uvm[:, :2] - HALFPATCH - base)
        res = cur - ref + uvm[:, 2:3]
        Jres2 = torch.sum(res[:, :, None] * J2, dim=1)
        upd2 = torch.sum(H2inv * Jres2[:, None, :], dim=2)
        Jres1 = torch.sum(res[:, :, None] * J1, dim=1)
        upd1 = torch.sum(H1inv * Jres1[:, None, :], dim=2)
        upd = torch.where(
            is_1d[:, None],
            torch.cat([upd1[:, 0:1] * direction, upd1[:, 1:2]], -1), upd2)
        step2 = torch.where(is_1d, upd1[:, 0] ** 2,
                            upd2[:, 0] ** 2 + upd2[:, 1] ** 2)
        act = valid & in_img
        uvm = torch.where(act[:, None], uvm - upd, uvm)
        conv = conv | (act & (step2 < CONV_EPS))
    return uvm[:, :2], conv & valid


def align2d(cur_pad, ref_patch_border: torch.Tensor, px_init: torch.Tensor,
            valid: torch.Tensor, n_iter: int = 10,
            level: torch.Tensor | None = None):
    """Batched align2D (every item 2-D)."""
    return align_features(cur_pad, ref_patch_border, px_init, valid, n_iter,
                          level)
