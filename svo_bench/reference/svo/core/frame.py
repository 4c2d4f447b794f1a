"""Per-frame state: pyramid, pose and the feature table.

Port of ``rpg_svo_tpu/core/frame.py`` (the reference's Frame,
svo/src/frame.cpp): the feature list is a fixed table of slots with a
validity mask, and the pyramid is carried as its padded stack (``pad``,
the storage layout every sampler and kernel reads), as per-level views of
that stack (``pyr``) and as the flat per-item-level view (``flat``).
``scene_depth`` (frame_utils::getSceneDepth, frame.cpp:167-188) takes the
frame as its pose and feature table, so the fused step can call it too.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.ops.interp import FlatPyramid
from svo_bench.reference.svo.ops.pyramid import build_padded_pyramid
from svo_bench.reference.svo.ops.robust import masked_median
from svo_bench.reference.svo.ops.tiles import PaddedPyramid


class FrameState(NamedTuple):
    pyr: Tuple[torch.Tensor, ...]   # per-level views of pad.stack
    pad: PaddedPyramid
    flat: FlatPyramid
    R: torch.Tensor                 # (3, 3) T_f_w rotation
    t: torch.Tensor                 # (3,)
    frame_id: torch.Tensor          # int32
    timestamp: float
    feat_px: torch.Tensor           # (F, 2)
    feat_f: torch.Tensor            # (F, 3)
    feat_level: torch.Tensor        # (F,) int32
    feat_point: torch.Tensor        # (F,) int32 point id, -1 none
    feat_valid: torch.Tensor        # (F,) bool
    feat_type: torch.Tensor         # (F,) int32
    feat_grad: torch.Tensor         # (F, 2)

    @property
    def T_f_w(self) -> SE3:
        return SE3(self.R, self.t)

    def with_pose(self, T: SE3) -> "FrameState":
        return self._replace(R=T.R, t=T.t)


def make_frame(img: torch.Tensor, n_levels: int, n_feats: int,
               frame_id: int, timestamp: float,
               T_f_w: SE3 | None = None) -> FrameState:
    """A frame of ``img`` (on its device) with an empty n_feats-slot
    feature table; the pose defaults to the identity."""
    return frame_from_pad(build_padded_pyramid(img, n_levels), n_feats,
                          frame_id, timestamp, T_f_w)


def frame_from_pad(pad: PaddedPyramid, n_feats: int, frame_id: int,
                   timestamp: float, T_f_w: SE3 | None = None) -> FrameState:
    """``make_frame`` of an already built padded pyramid."""
    dev = pad.stack.device
    if T_f_w is None:
        T_f_w = SE3.identity(device=dev)
    return FrameState(
        pyr=pad.levels(), pad=pad, flat=pad.flat_view(),
        R=T_f_w.R, t=T_f_w.t,
        frame_id=torch.tensor(frame_id, dtype=torch.int32, device=dev),
        timestamp=float(timestamp),
        feat_px=torch.zeros((n_feats, 2), device=dev),
        feat_f=torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(n_feats, 1),
        feat_level=torch.zeros((n_feats,), dtype=torch.int32, device=dev),
        feat_point=torch.full((n_feats,), -1, dtype=torch.int32, device=dev),
        feat_valid=torch.zeros((n_feats,), dtype=torch.bool, device=dev),
        feat_type=torch.zeros((n_feats,), dtype=torch.int32, device=dev),
        feat_grad=torch.tensor([1.0, 0.0], device=dev).repeat(n_feats, 1))


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
