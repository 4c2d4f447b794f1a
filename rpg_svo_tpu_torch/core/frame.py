"""Per-frame helpers (part).

Port of ``scene_depth`` from ``rpg_svo_tpu/core/frame.py``
(frame_utils::getSceneDepth, frame.cpp:167-188).  The frame state itself
(``FrameState``, ``make_frame``) comes with the host pipeline; here the
frame is given by its pose and its feature table.
"""

from __future__ import annotations

import torch

from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.ops.robust import masked_median


def scene_depth(T_f_w: SE3, feat_point: torch.Tensor,
                feat_valid: torch.Tensor, point_pos: torch.Tensor):
    """Median and minimum z-depth of the frame's observed points:
    (depth_mean, depth_min); 1.0 without any, and the minimum falls back
    to the median.  point_pos: the whole point pool (P, 3)."""
    pid = torch.clamp(feat_point, 0, point_pos.shape[0] - 1).to(torch.int64)
    z = T_f_w.apply(point_pos[pid])[..., 2]
    ok = feat_valid & (feat_point >= 0) & (z > 0)
    depth_mean = masked_median(z, ok, default=1.0)
    depth_min = torch.amin(torch.where(ok, z, torch.full_like(z, float("inf"))))
    depth_min = torch.where(torch.isfinite(depth_min), depth_min, depth_mean)
    return depth_mean, depth_min
