"""Creation-time reference patch tiles and their resampling.

Port of ``rpg_svo_tpu/ops/patches.py``.  When a feature is created, a
TILE_R x TILE_R integer tile around it is cut once from its own pyramid
level (through the tile gather, kernel K1 on the card) and stored beside
the feature; later affine patch warps sample that tile instead of the
keyframe pyramid.  The sampler computes its bilinear or Catmull-Rom taps
directly; the JAX package's one-hot contractions are TPU layout work.
"""

from __future__ import annotations

from typing import Tuple

import torch

TILE_R = 24


def extract_tiles(pad, px0: torch.Tensor, level: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer tiles around level-0 coords px0 (N, 2) at per-item level.

    Returns (tiles (N, TILE_R*TILE_R) float32 flat rows, xy0 (N, 2) int32
    tile origins in level coords, clamped inside the level)."""
    from svo_bench.reference.svo.ops.tiles import gather_tiles
    scale = torch.exp2(level.to(torch.float32))
    pl_ = px0 / scale[:, None]
    cx = torch.round(pl_[:, 0]).to(torch.int32)
    cy = torch.round(pl_[:, 1]).to(torch.int32)
    vals, x0, y0 = gather_tiles(pad, level, cx - TILE_R // 2,
                                cy - TILE_R // 2, TILE_R, TILE_R)
    return (vals.reshape(vals.shape[0], TILE_R * TILE_R),
            torch.stack([x0, y0], dim=-1))


def empty_tiles(n: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Placeholder tiles marked invalid (xy0 = -1)."""
    return (torch.zeros((n, TILE_R * TILE_R), dtype=torch.float32,
                        device=device),
            torch.full((n, 2), -1, dtype=torch.int32, device=device))


def catmull_rom_weights(t):
    """4-tap Catmull-Rom weights at fractional offset t for taps at
    offsets (-1, 0, +1, +2)."""
    t2 = t * t
    t3 = t2 * t
    return ((-0.5 * t3 + t2 - 0.5 * t),
            (1.5 * t3 - 2.5 * t2 + 1.0),
            (-1.5 * t3 + 2.0 * t2 + 0.5 * t),
            (0.5 * t3 - 0.5 * t2))


def sample_tiles(tiles: torch.Tensor, xy0: torch.Tensor,
                 coords_lvl: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear samples of tiles (N, T*T) or (N, T, T) at level coords
    (N, P, 2).  Returns (vals (N, P), ok (N, P)); samples outside the tile,
    or of items without a tile (xy0 < 0), are invalid and read 0.

    Same arithmetic as the JAX one-hot form: interpolate along x first,
    then along y."""
    if tiles.dim() == 2:
        side = int(round(tiles.shape[-1] ** 0.5))
        tiles = tiles.reshape(tiles.shape[0], side, side)
    N, T = tiles.shape[0], tiles.shape[-1]
    local = coords_lvl - xy0[:, None, :].to(torch.float32)
    x, y = local[..., 0], local[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    ok = (x0 >= 0) & (y0 >= 0) & (x0 < T - 1) & (y0 < T - 1) \
        & (xy0[:, None, 0] >= 0)
    xi = torch.clamp(x0.to(torch.int64), 0, T - 2)
    yi = torch.clamp(y0.to(torch.int64), 0, T - 2)
    flat = tiles.reshape(N, T * T)
    idx = yi * T + xi
    g = lambda k: torch.gather(flat, 1, idx + k)  # noqa: E731
    top = g(0) * (1.0 - wx) + g(1) * wx
    bot = g(T) * (1.0 - wx) + g(T + 1) * wx
    vals = top * (1.0 - wy) + bot * wy
    return torch.where(ok, vals, torch.zeros_like(vals)), ok
