"""The padded pyramid stack and its tile gather, plain.

A frozen copy of the port's ``ops/tiles.py`` with the CUDA kernel K1 and
its stream-batched custom op taken out: ``gather_tiles`` is always the
plain twin (a torch clamp and a flat-index gather).  The layout (levels
padded to 8 rows and 128 columns, stacked with 40 rows of tail slack) is
the port's, so the reference reads the program's states as they are.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree


TAIL_ROWS = 40
MAX_LEVELS = 8          # the kernels' level-table capacity


def padded_layout(shapes: Sequence[Tuple[int, int]]):
    """(Ws, Hs, row_off) of the padded stack for the given level shapes."""
    Ws = max(256, -(-max(w for _, w in shapes) // 128) * 128)
    offs = []
    row = 0
    for h, _ in shapes:
        offs.append(row)
        row += -(-h // 8) * 8
    return Ws, row + TAIL_ROWS, np.asarray(offs, dtype=np.int32)


# unbounded: a captured CUDA graph (core/graphed.py) reads the table at
# its address, so an evicted table would leave a graph reading freed
# memory; one (3, L) table per layout and device lives for the process
@functools.cache
def _level_table(shapes: Tuple[Tuple[int, int], ...], device: str):
    """(W, H, row_off) per level as int32 tensors on ``device``, made once
    per layout so the per-frame path never copies constants to the card."""
    _, _, offs = padded_layout(shapes)
    tab = np.stack([np.asarray([w for _, w in shapes], np.int32),
                    np.asarray([h for h, _ in shapes], np.int32), offs])
    return torch.from_numpy(tab).to(device)


@dataclasses.dataclass(frozen=True)
class PaddedPyramid:
    """Pyramid levels padded and vertically stacked into one 2-D tensor.

    stack: (Hs, Ws) float32; level l occupies rows row_off[l] .. +Hp[l],
    with the real (h, w) content at the top left and zeros elsewhere."""
    stack: torch.Tensor
    shapes: Tuple[Tuple[int, int], ...]

    @property
    def Ws(self) -> int:
        return padded_layout(self.shapes)[0]

    @property
    def Hs(self) -> int:
        return padded_layout(self.shapes)[1]

    @property
    def row_off(self) -> np.ndarray:
        return padded_layout(self.shapes)[2]

    @classmethod
    def from_levels(cls, levels: Sequence[torch.Tensor]) -> "PaddedPyramid":
        shapes = tuple((int(l.shape[0]), int(l.shape[1])) for l in levels)
        Ws, Hs, offs = padded_layout(shapes)
        # each level zero-padded to its rows and the stack's width, then
        # the tail rows: built out of place, so that it batches under vmap
        rows = [F.pad(img.to(torch.float32),
                      (0, Ws - w, 0, -(-h // 8) * 8 - h))
                for (h, w), img in zip(shapes, levels)]
        rows.append(torch.zeros((TAIL_ROWS, Ws), dtype=torch.float32,
                                device=levels[0].device))
        return cls(torch.cat(rows), shapes)

    @classmethod
    def from_stack(cls, stack: torch.Tensor,
                   shapes: Sequence[Tuple[int, int]]) -> "PaddedPyramid":
        """Wrap an existing padded stack (no data movement)."""
        shapes = tuple((int(h), int(w)) for h, w in shapes)
        Ws, Hs, _ = padded_layout(shapes)
        return cls(stack.reshape(Hs, Ws), shapes)

    def levels(self) -> Tuple[torch.Tensor, ...]:
        """Per-level images as views of the stack."""
        return tuple(self.stack[int(o): int(o) + h, :w]
                     for o, (h, w) in zip(self.row_off, self.shapes))

    def flat_view(self):
        """Strided FlatPyramid over this stack (zero-copy)."""
        from svo_bench.reference.svo.ops.interp import FlatPyramid
        return FlatPyramid.from_padded(self)

    def level_table(self) -> torch.Tensor:
        """(3, L) int32 device table: widths, heights, first rows."""
        return _level_table(self.shapes, str(self.stack.device))


# a pytree node, so that stacked states (parallel/streams.py) and vmap carry
# the stack as their leaf; the level shapes are static
pytree.register_pytree_node(
    PaddedPyramid, lambda p: ([p.stack], p.shapes),
    lambda leaves, shapes: PaddedPyramid(leaves[0], shapes),
    serialized_type_name="svo_bench.reference.svo.ops.tiles.PaddedPyramid")


def gather_tiles_plain(pyr: PaddedPyramid, level: torch.Tensor,
                       x0: torch.Tensor, y0: torch.Tensor, tile_h: int,
                       tile_w: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's plain twin: the clamp as torch ops against the device level
    table, then a flat-index gather (as ``pallas_tiles.gather_tiles``' XLA
    fallback)."""
    tab = pyr.level_table()
    lv = torch.clamp(level.to(torch.int64), 0, len(pyr.shapes) - 1)
    W, H, off = tab[0][lv], tab[1][lv], tab[2][lv]
    zero = torch.zeros_like(W)
    x0c = torch.clamp(x0.to(torch.int32), zero,
                      torch.clamp(W - tile_w, min=0))
    y0c = torch.clamp(y0.to(torch.int32), zero,
                      torch.clamp(H - tile_h, min=0))
    dev = pyr.stack.device
    r = torch.arange(tile_h, dtype=torch.int64, device=dev)
    c = torch.arange(tile_w, dtype=torch.int64, device=dev)
    yy = (y0c + off).to(torch.int64)[:, None, None] + r[None, :, None]
    xx = x0c.to(torch.int64)[:, None, None] + c[None, None, :]
    tiles = pyr.stack.reshape(-1)[yy * pyr.stack.shape[1] + xx]
    return tiles, x0c, y0c


def gather_tiles(pyr: PaddedPyramid, level: torch.Tensor, x0: torch.Tensor,
                 y0: torch.Tensor, tile_h: int, tile_w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather (N, tile_h, tile_w) integer tiles at per-item pyramid level.

    (x0, y0) are requested origins in LEVEL coords (int32); they are clamped
    into the level.  Returns (tiles, x0c, y0c) with the clamped origins
    (int32).  A CUDA stack goes through kernel K1 (one launch, nothing
    else), a CPU stack through its plain twin; a stream batch under vmap
    goes through ``tile_gather_op`` (one launch for every stream)."""
    return gather_tiles_plain(pyr, level, x0, y0, tile_h, tile_w)
