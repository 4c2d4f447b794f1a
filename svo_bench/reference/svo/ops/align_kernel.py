"""Stand-in for the port's ``ops/align_kernel.py``: the patch constants
and ``level_tiles`` of the plain alignment; K2 never serves the
reference, so ``sparse_img_align`` always runs ``sparse_img_align_plain``.
"""

from __future__ import annotations

import torch

from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.ops.tiles import gather_tiles

PATCH_HALFSIZE = 2
PATCH_SIZE = 4
SLACK = 6
TILE = PATCH_SIZE + 1 + 2 * SLACK   # 17


def use_align_kernel(cam, cur_pad, robust: bool) -> bool:
    return False


def sparse_align_kernel(*args, **kwargs):
    raise RuntimeError("the reference has no alignment kernel")


def level_tiles(cur_pad, cam, T_init: SE3, p_ref: torch.Tensor, level: int,
                gather=gather_tiles):
    """Each feature's (TILE, TILE) tile around its initial projection at
    ``level``, with the clamped origins: (tiles, x0c, y0c); ``gather`` has
    ``gather_tiles``' signature."""
    scale = 1.0 / (2.0 ** level)
    uv0 = cam.world2cam(T_init.apply(p_ref)) * scale
    base = torch.floor(uv0).to(torch.int32) - PATCH_HALFSIZE - SLACK
    lv = torch.full((p_ref.shape[0],), level, dtype=torch.int32,
                    device=p_ref.device)
    return gather(cur_pad, lv, base[:, 0], base[:, 1], TILE, TILE)
