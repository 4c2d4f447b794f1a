"""Bilinear image sampling and the flat per-item-level pyramid views.

Port of ``rpg_svo_tpu/ops/interp.py``: batched bilinear/nearest sampling
with validity masks, the static patch offset grid and patch extraction,
``FlatPyramid``, a flat view of a pyramid where the pyramid level is a
per-query tensor (flat index = level offset + y * stride + x),
``BoundPyramidPool``, a (K, L) pool of packed pyramids sampled at a
per-query pyramid index, and central-difference image gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree


def _bilinear_flat(flat, base, S, W, H, xy, fill):
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    valid = (x0 >= 0) & (y0 >= 0) & (x0 < (W - 1)) & (y0 < (H - 1))
    xi = torch.clamp(x0.to(torch.int64), torch.zeros_like(W), W - 2)
    yi = torch.clamp(y0.to(torch.int64), torch.zeros_like(H), H - 2)
    idx = base + yi * S + xi
    top = flat[idx] * (1.0 - wx) + flat[idx + 1] * wx
    bot = flat[idx + S] * (1.0 - wx) + flat[idx + S + 1] * wx
    vals = top * (1.0 - wy) + bot * wy
    return torch.where(valid, vals, torch.full_like(vals, fill)), valid


def bilinear(img: torch.Tensor, xy: torch.Tensor, fill: float = 0.0):
    """Sample img (H, W) at float coords xy (..., 2) = (x, y); returns
    (values, valid) where valid marks a fully inside 4-pixel support."""
    H, W = img.shape
    dev = img.device
    # sizes by a fill on the device (a copy from host memory is what a
    # CUDA graph's capture refuses)
    t = lambda v: torch.full((), v, dtype=torch.int64, device=dev)  # noqa: E731
    return _bilinear_flat(img.reshape(-1), 0, W, t(W), t(H), xy, fill)


def patch_grid(halfsize: int, border: int = 0, device="cpu") -> torch.Tensor:
    """Static (P*P, 2) offset table (x, y) of a (2*(halfsize+border))^2
    patch relative to its center, row-major."""
    size = 2 * (halfsize + border)
    r = torch.arange(size, dtype=torch.float32, device=device) \
        - (halfsize + border)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def extract_patches(img: torch.Tensor, centers: torch.Tensor,
                    halfsize: int, border: int = 0):
    """Bilinear patches around centers (N, 2) -> (N, P*P), valid (N,):
    a patch is valid only if every sample lies inside the image."""
    grid = patch_grid(halfsize, border, device=img.device)
    vals, ok = bilinear(img, centers[:, None, :] + grid[None, :, :])
    return vals, torch.all(ok, dim=-1)


def _packed_table(shapes, device) -> torch.Tensor:
    """(4, L) int64 [offset, width, height, row stride] of levels packed
    back to back, each with its own width as row stride."""
    offs = np.cumsum([0] + [h * w for h, w in shapes])[:-1]
    tab = np.asarray([offs, [w for _, w in shapes], [h for h, _ in shapes],
                      [w for _, w in shapes]], dtype=np.int64)
    return torch.from_numpy(tab).to(device)


@dataclasses.dataclass(frozen=True)
class FlatPyramid:
    """Per-item-level sampler over a flat pyramid buffer.

    table: (4, L) int64 per-level [offset, width, height, row stride]."""
    flat: torch.Tensor
    table: torch.Tensor
    shapes: Tuple[Tuple[int, int], ...]

    @classmethod
    def from_levels(cls, levels: Sequence[torch.Tensor]) -> "FlatPyramid":
        """All levels concatenated into one packed flat buffer (the JAX
        package's ``FlatPyramid(levels)``)."""
        shapes = tuple((int(l.shape[0]), int(l.shape[1])) for l in levels)
        return cls(torch.cat([l.reshape(-1) for l in levels]),
                   _packed_table(shapes, levels[0].device), shapes)

    @classmethod
    def from_padded(cls, pad) -> "FlatPyramid":
        """Zero-copy view of a PaddedPyramid: level l starts at
        row_off[l] * Ws with row stride Ws; extent is the true (h, w)."""
        tab = pad.level_table().to(torch.int64)
        table = torch.stack([tab[2] * pad.Ws, tab[0], tab[1],
                             torch.full_like(tab[0], pad.Ws)])
        return cls(pad.stack.reshape(-1), table, pad.shapes)

    @property
    def n_levels(self) -> int:
        return len(self.shapes)

    def _level(self, level: torch.Tensor):
        lv = torch.clamp(level.to(torch.int64), 0, self.n_levels - 1)
        return (self.table[0][lv], self.table[1][lv], self.table[2][lv],
                self.table[3][lv])

    def bilinear(self, level: torch.Tensor, xy: torch.Tensor,
                 fill: float = 0.0):
        """Sample at level-``level`` coords xy (..., 2); level broadcasts
        against xy's batch dims."""
        base, W, H, S = self._level(level)
        return _bilinear_flat(self.flat, base, S, W, H, xy, fill)

    def nearest(self, level: torch.Tensor, xy: torch.Tensor,
                fill: float = 0.0):
        """Nearest-pixel sampling (round half to even, as jnp.round)."""
        base, W, H, S = self._level(level)
        xi = torch.round(xy[..., 0]).to(torch.int64)
        yi = torch.round(xy[..., 1]).to(torch.int64)
        valid = (xi >= 0) & (yi >= 0) & (xi < W) & (yi < H)
        zero = torch.zeros_like(W)
        idx = base + torch.clamp(yi, zero, H - 1) * S \
            + torch.clamp(xi, zero, W - 1)
        vals = self.flat[idx]
        return torch.where(valid, vals, torch.full_like(vals, fill)), valid


class BoundPyramidPool:
    """A (K, L) pool of packed flat pyramids sharing one level layout,
    bound to a per-query pyramid index ``idx`` (N,): item i samples
    pyramid idx[i] (clamped; callers mask idx < 0).  Same
    ``bilinear(level, xy)`` interface as FlatPyramid."""

    def __init__(self, pool_flat: torch.Tensor, shapes, idx: torch.Tensor):
        self.shapes = tuple((int(h), int(w)) for h, w in shapes)
        self.table = _packed_table(self.shapes, pool_flat.device)
        self.pool = pool_flat
        self.idx = idx

    @property
    def n_levels(self) -> int:
        return len(self.shapes)

    def bilinear(self, level: torch.Tensor, xy: torch.Tensor,
                 fill: float = 0.0):
        """xy (N, ..., 2); level broadcasts against xy's batch dims."""
        lv = torch.clamp(level.to(torch.int64), 0, self.n_levels - 1)
        off, W, H = self.table[0][lv], self.table[1][lv], self.table[2][lv]
        k = torch.clamp(self.idx.to(torch.int64), 0, self.pool.shape[0] - 1)
        k = k.reshape(k.shape + (1,) * (xy.dim() - k.dim() - 1))
        return _bilinear_flat(self.pool.reshape(-1),
                              k * self.pool.shape[1] + off, W, W, H, xy, fill)


# pytree nodes, so that a jitted stage (core/graphed.jit) takes their
# tensors as inputs; the level shapes are static
pytree.register_pytree_node(
    FlatPyramid, lambda p: ([p.flat, p.table], p.shapes),
    lambda leaves, shapes: FlatPyramid(leaves[0], leaves[1], shapes),
    serialized_type_name="svo_bench.reference.svo.ops.interp.FlatPyramid")


def _bound_pool(leaves, shapes) -> BoundPyramidPool:
    p = BoundPyramidPool.__new__(BoundPyramidPool)
    p.pool, p.table, p.idx = leaves
    p.shapes = shapes
    return p


pytree.register_pytree_node(
    BoundPyramidPool, lambda p: ([p.pool, p.table, p.idx], p.shapes),
    _bound_pool,
    serialized_type_name="svo_bench.reference.svo.ops.interp.BoundPyramidPool")


def image_gradients(img: torch.Tensor):
    """Central-difference gradients (dx, dy), 0.5 * (I[+1] - I[-1]), same
    shape; they wrap around at the borders, as the reference's roll."""
    dx = 0.5 * (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1))
    dy = 0.5 * (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0))
    return dx, dy
