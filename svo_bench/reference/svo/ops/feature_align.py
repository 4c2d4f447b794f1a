"""Subpixel feature alignment (batched inverse-compositional KLT).

Port of ``rpg_svo_tpu/ops/feature_align.py`` (feature_alignment::align2D /
align1D, svo/src/feature_alignment.cpp): 8x8 patch with gradients from a
10x10 bordered reference patch, estimated (u, v, mean offset) for 2-D items
and (step along a direction, mean offset) for 1-D items, fixed Hessians,
0.03 px convergence test.

Each item's current-image window is sampled from one 17x17 tile gathered
around its start: from a padded pyramid through the tile gather (kernel K1
on the card; the origin is clamped into the level, so the tile is always
backed), from a ``FlatPyramid`` or a raw (H, W) image by plain gathers
with per-pixel validity.  Iteration ``it`` of ``n_iter`` interpolates the
window with the 4-tap Catmull-Rom kernel when ``BICUBIC`` and
``it >= n_iter - BICUBIC_LAST``, else bilinearly, as the JAX package does
(both read ``SVO_BICUBIC`` / ``SVO_BICUBIC_LAST`` at import).  Taps are
computed directly; the one-hot selection contractions of the JAX package
are TPU layout work.
"""

from __future__ import annotations

import os as _os
from typing import Tuple

import torch

from svo_bench.reference.svo.core import graphed
from svo_bench.reference.svo.geometry.linalg import inv2x2, inv3x3
from svo_bench.reference.svo.ops.interp import FlatPyramid, bilinear, patch_grid
from svo_bench.reference.svo.ops.patches import catmull_rom_weights

HALFPATCH = 4
PATCH = 2 * HALFPATCH          # 8
BORDERED = PATCH + 2           # 10
CONV_EPS = 0.03 * 0.03
# the interpolant schedule: the last BICUBIC_LAST iterations are cubic
BICUBIC = _os.environ.get("SVO_BICUBIC", "1") != "0"
BICUBIC_LAST = int(_os.environ.get("SVO_BICUBIC_LAST", "10"))
SLACK = 4
TILE = PATCH + 1 + 2 * SLACK   # 17


def extract_patch_with_border(img: torch.Tensor, centers: torch.Tensor):
    """Bilinear 10x10 patches around centers (N, 2) -> (N, 100), valid (N,)."""
    grid = patch_grid(HALFPATCH, 1, device=img.device)
    vals, ok = bilinear(img, centers[:, None, :] + grid[None])
    return vals, torch.all(ok, dim=-1)


def _gather_tile(cur_img, level, px_init: torch.Tensor):
    """One (TILE, TILE) integer-pixel tile per item around px_init:
    (base (N, 2) float tile origin, tiles (N, TILE, TILE), ok).

    A PaddedPyramid goes through ``gather_tiles`` (K1 on the card), which
    clamps the origin into the level, so every pixel is backed and ok is
    None; a FlatPyramid (nearest samples at per-item ``level``) or a raw
    (H, W) image gives per-pixel ok marks (N, TILE, TILE)."""
    from svo_bench.reference.svo.ops.tiles import PaddedPyramid, gather_tiles
    base = torch.floor(px_init).to(torch.int32) - HALFPATCH - SLACK
    if isinstance(cur_img, PaddedPyramid):
        vals, x0c, y0c = gather_tiles(cur_img, level, base[:, 0],
                                      base[:, 1], TILE, TILE)
        return torch.stack([x0c, y0c], dim=-1).to(torch.float32), vals, None
    r = torch.arange(TILE, dtype=torch.int64, device=px_init.device)
    xg = base[:, 0, None, None].to(torch.int64) + r[None, None, :]
    yg = base[:, 1, None, None].to(torch.int64) + r[None, :, None]
    if isinstance(cur_img, FlatPyramid):
        xy = torch.stack(torch.broadcast_tensors(xg, yg), dim=-1)
        vals, ok = cur_img.nearest(level[:, None, None], xy.to(torch.float32))
    else:
        H, W = cur_img.shape
        ok = (xg >= 0) & (yg >= 0) & (xg < W) & (yg < H)
        idx = torch.clamp(yg, 0, H - 1) * W + torch.clamp(xg, 0, W - 1)
        vals = torch.where(ok, cur_img.reshape(-1)[idx],
                           torch.zeros((), device=px_init.device))
    return base.to(torch.float32), vals, ok


def _window(tile: torch.Tensor, ok, o: torch.Tensor, bicubic: bool):
    """The 8x8 window at float offset o (N, 2) into the tiles, interpolated
    along y first, then along x, as the reference's selection contractions:
    (cur (N, 64) row-major, usable (N,)).  Usable needs the window's taps
    inside the tile and, where ok (N, TILE, TILE) is given, every tap
    backed by a valid pixel."""
    N = tile.shape[0]
    oi = torch.floor(o)
    w = o - oi
    oi = oi.to(torch.int64)
    if bicubic:
        lo, hi, first = 1, TILE - PATCH - 2, -1
        wy, wx = catmull_rom_weights(w[:, 1]), catmull_rom_weights(w[:, 0])
    else:
        lo, hi, first = 0, TILE - PATCH - 1, 0
        wy, wx = (1.0 - w[:, 1], w[:, 1]), (1.0 - w[:, 0], w[:, 0])
    usable = (oi[:, 0] >= lo) & (oi[:, 1] >= lo) \
        & (oi[:, 0] <= hi) & (oi[:, 1] <= hi)
    ox = torch.clamp(oi[:, 0], lo, hi) + first
    oy = torch.clamp(oi[:, 1], lo, hi) + first
    R = PATCH + len(wy) - 1                       # the taps' extent
    r = torch.arange(R, device=tile.device)
    idx = ((oy[:, None, None] + r[None, :, None]) * TILE
           + ox[:, None, None] + r[None, None, :]).reshape(N, -1)
    reg = torch.gather(tile.reshape(N, -1), 1, idx).reshape(N, R, R)
    if ok is not None:
        usable = usable & torch.gather(ok.reshape(N, -1), 1, idx).all(dim=1)
    rows = None
    for k, wk in enumerate(wy):
        term = wk[:, None, None] * reg[:, k: k + PATCH, :]
        rows = term if rows is None else rows + term
    cur = None
    for k, wk in enumerate(wx):
        term = wk[:, None, None] * rows[:, :, k: k + PATCH]
        cur = term if cur is None else cur + term
    return cur.reshape(N, PATCH * PATCH), usable


def _border_gradients(patch_b: torch.Tensor):
    pb = patch_b.reshape(-1, BORDERED, BORDERED)
    inner = pb[:, 1:-1, 1:-1]
    dx = 0.5 * (pb[:, 1:-1, 2:] - pb[:, 1:-1, :-2])
    dy = 0.5 * (pb[:, 2:, 1:-1] - pb[:, :-2, 1:-1])
    n = PATCH * PATCH
    return inner.reshape(-1, n), dx.reshape(-1, n), dy.reshape(-1, n)


@graphed.jit(static_argnames=("n_iter",))
def align_features(cur_img, ref_patch_border: torch.Tensor,
                   px_init: torch.Tensor, valid: torch.Tensor,
                   n_iter: int = 10, level: torch.Tensor | None = None,
                   direction: torch.Tensor | None = None,
                   is_1d: torch.Tensor | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched subpixel refinement; returns (px, converged (N,)).

    cur_img: a PaddedPyramid or FlatPyramid with per-item pyramid
    ``level`` (px in level coords; level 0 where None), or a raw (H, W)
    image.  Items with is_1d run align1D along ``direction`` (unit, (N,
    2)), the others align2D.

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
        direction[:, 0].fill_(1.0)
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

    base, tile, tok = _gather_tile(cur_img, level, px_init)
    uvm = torch.cat([px_init, torch.zeros_like(px_init[:, :1])], dim=-1)
    conv = torch.zeros_like(valid)
    for it in range(n_iter):
        cubic = BICUBIC and it >= n_iter - BICUBIC_LAST
        cur, in_img = _window(tile, tok, uvm[:, :2] - HALFPATCH - base,
                              cubic)
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


@graphed.jit(static_argnames=("n_iter",))
def align2d(cur_img, ref_patch_border: torch.Tensor, px_init: torch.Tensor,
            valid: torch.Tensor, n_iter: int = 10,
            level: torch.Tensor | None = None):
    """Batched align2D (every item 2-D)."""
    return align_features(cur_img, ref_patch_border, px_init, valid, n_iter,
                          level)


@graphed.jit(static_argnames=("n_iter",))
def align1d(cur_img, ref_patch_border: torch.Tensor, px_init: torch.Tensor,
            direction: torch.Tensor, valid: torch.Tensor, n_iter: int = 10,
            level: torch.Tensor | None = None):
    """Batched align1D along ``direction`` (every item 1-D)."""
    ones = torch.ones(px_init.shape[:1], dtype=torch.bool,
                      device=px_init.device)
    return align_features(cur_img, ref_patch_border, px_init, valid, n_iter,
                          level, direction=direction, is_1d=ones)
