"""Observability: per-frame Info records and annotated images.

Port of ``rpg_svo_tpu/viz.py`` (svo_ros Visualizer, svo_msgs/Info and the
rqt_svo readout, without ROS): Info is a plain record of the pipeline's
per-frame dict, the feature overlays draw squares for corners and
segments for edgelets, and ``status_line`` reproduces the rqt widget's
fps / matches / stage / quality readout as text.  Drawing is numpy on the
host; tensors are read to it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from rpg_svo_tpu_torch.geometry.se3 import rot_to_quat


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Info:
    """svo_msgs/Info equivalent (visualizer.cpp:77-92)."""
    frame_id: int
    timestamp: float
    processing_time: float
    num_matches: int
    tracking_quality: str
    stage: str
    is_keyframe: bool

    @staticmethod
    def from_frame_info(info: dict, quality: str = "good") -> "Info":
        return Info(
            frame_id=info.get("frame_id", -1),
            timestamp=info.get("timestamp", 0.0),
            processing_time=info.get("proc_time", 0.0),
            num_matches=info.get("repr_n_new_references", 0),
            tracking_quality=quality,
            stage=info.get("stage", "?"),
            is_keyframe=bool(info.get("is_keyframe", False)),
        )


def _draw_line(out: np.ndarray, p0, p1, value: float) -> None:
    """Rasterize a line segment into a grayscale image (in place)."""
    H, W = out.shape
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.clip(np.round(np.linspace(p0[0], p1[0], n)).astype(int),
                 0, W - 1)
    ys = np.clip(np.round(np.linspace(p0[1], p1[1], n)).astype(int),
                 0, H - 1)
    out[ys, xs] = value


def draw_features(img, px, valid, halfsize: int = 2, value: float = 255.0,
                  feat_type=None, grad=None) -> np.ndarray:
    """Overlay features on a grayscale image (visualizer.cpp:137-161):
    corners as squares, edgelets (feat_type == 1, ``grad`` their unit
    gradient) as segments px +- 3 (grad_y, -grad_x).  Returns a copy."""
    out = _np(img).copy()
    H, W = out.shape
    ft = None if feat_type is None else _np(feat_type)
    gr = None if grad is None else _np(grad)
    for i, (p, v) in enumerate(zip(_np(px), _np(valid))):
        if not v:
            continue
        if ft is not None and gr is not None and ft[i] == 1:
            g0, g1 = float(gr[i][0]), float(gr[i][1])
            _draw_line(out, (p[0] + 3 * g1, p[1] - 3 * g0),
                       (p[0] - 3 * g1, p[1] + 3 * g0), value)
            continue
        x, y = int(p[0]), int(p[1])
        x0, x1 = max(x - halfsize, 0), min(x + halfsize, W - 1)
        y0, y1 = max(y - halfsize, 0), min(y + halfsize, H - 1)
        out[y0, x0:x1 + 1] = value
        out[y1, x0:x1 + 1] = value
        out[y0:y1 + 1, x0] = value
        out[y0:y1 + 1, x1] = value
    return out


def draw_init_tracks(img, px_ref, px_cur, valid,
                     value: float = 255.0) -> np.ndarray:
    """Bootstrap overlay: track lines from the first to the current frame
    (visualizer.cpp:117-127).  Returns a copy."""
    out = _np(img).copy()
    for p0, p1, v in zip(_np(px_ref), _np(px_cur), _np(valid)):
        if v:
            _draw_line(out, p1, p0, value)
    return out


@dataclasses.dataclass
class Markers:
    """The rviz marker set as data (visualizer.cpp:198-267): the current
    camera, the trajectory point it appends, keyframe markers, live point
    markers and the ids whose markers must be removed (deleted points)."""
    cam_pos: np.ndarray         # (3,) current camera position (world)
    cam_R_wc: np.ndarray        # (3, 3) camera-to-world rotation
    trajectory_id: int          # marker id = trace counter
    kf_ids: np.ndarray          # (nK,) keyframe frame ids
    kf_pos: np.ndarray          # (nK, 3) keyframe positions (world)
    kf_R_wc: np.ndarray         # (nK, 3, 3)
    point_ids: np.ndarray       # (nP,) live point ids (pool slots)
    point_pos: np.ndarray       # (nP, 3)
    deleted_ids: np.ndarray     # ids whose point markers to delete


def markers_from_map(m, T_f_w, trace_id: int = 0) -> Markers:
    """The marker set of the map and the current pose (visualizeMarkers,
    publishMapRegion, removeDeletedPts)."""
    R = _np(T_f_w.R)
    t = _np(T_f_w.t)
    kf_act = _np(m.kf.active)
    kf_R = _np(m.kf.R)[kf_act]
    kf_t = _np(m.kf.t)[kf_act]
    ptype = _np(m.pt.ptype)
    live = ptype > 0                      # not TYPE_DELETED
    ids = np.arange(ptype.shape[0])
    return Markers(
        cam_pos=-R.T @ t, cam_R_wc=R.T, trajectory_id=trace_id,
        kf_ids=_np(m.kf.frame_id)[kf_act],
        kf_pos=-np.einsum("kij,kj->ki", kf_R.transpose(0, 2, 1), kf_t),
        kf_R_wc=kf_R.transpose(0, 2, 1),
        point_ids=ids[live], point_pos=_np(m.pt.pos)[live],
        deleted_ids=ids[~live & (_np(m.pt.orig_kf) >= 0)])


def status_line(info: Info, fps: Optional[float] = None) -> str:
    """The rqt_svo widget's readout as one line."""
    fps_s = f"{fps:6.1f} fps" if fps is not None else "   -   "
    return (f"[{info.stage:>7}] frame {info.frame_id:5d}  {fps_s}  "
            f"matches {info.num_matches:4d}  quality "
            f"{info.tracking_quality:<12} "
            f"{'KF' if info.is_keyframe else '  '}")


@dataclasses.dataclass
class DenseInput:
    """svo_msgs/DenseInput equivalent (visualizer.cpp:269-314): what a
    dense-reconstruction consumer needs of a frame."""
    frame_id: int
    timestamp: float
    image: np.ndarray          # (H, W) grayscale
    t_w_c: np.ndarray          # (3,) camera position in world
    q_w_c: np.ndarray          # (4,) xyzw camera orientation in world
    min_depth: float
    max_depth: float


def dense_input_from_frame(frame_id: int, timestamp: float,
                           image, T_f_w, point_pos_cam) -> DenseInput:
    """The DenseInput record: the camera in the world, and the min/max z
    of the frame's observed points in the camera frame
    (visualizer.cpp:285-297)."""
    z = torch.as_tensor(point_pos_cam)[:, 2]
    z = z[torch.isfinite(z) & (z > 0)]
    T_w_c = T_f_w.inverse()
    return DenseInput(
        frame_id=frame_id, timestamp=timestamp, image=_np(image),
        t_w_c=_np(T_w_c.t), q_w_c=_np(rot_to_quat(T_w_c.R)),
        min_depth=float(z.min()) if z.numel() else 0.0,
        max_depth=float(z.max()) if z.numel() else 0.0)


def pose_with_covariance(T_f_w, Cov, world_in_cam: bool = False):
    """Pose and 6x6 covariance for publishing (visualizer.cpp:163-196).

    world_in_cam=True returns (T_f_w, Cov) unchanged (the pose optimizer
    estimates the covariance in the camera frame); otherwise the camera in
    the world, with the covariance carried by the adjoint congruence
    Cov_w = Adj(T_w_c) Cov Adj(T_w_c)^T.  (The reference writes
    Adj(T) Cov Adj(T^-1), visualizer.cpp:182, which is not symmetric.)"""
    if world_in_cam:
        return T_f_w, _np(Cov)
    T_w_c = T_f_w.inverse()
    A = _np(T_w_c.adjoint())
    return T_w_c, A @ _np(Cov) @ A.T


class InfoStream:
    """Rolling per-frame Info records with an fps estimate over the last
    `window` frames (frame_handler_base's ring-buffer readout)."""

    def __init__(self, window: int = 10):
        self.infos: List[Info] = []
        self.window = window

    def push(self, info: Info):
        self.infos.append(info)

    @property
    def fps(self) -> Optional[float]:
        if len(self.infos) < 2:
            return None
        recent = self.infos[-self.window:]
        dt = [i.processing_time for i in recent if i.processing_time > 0]
        if not dt:
            return None
        return len(dt) / sum(dt)


@dataclasses.dataclass
class FeatureMsg:
    """svo_msgs/Feature equivalent: one tracked feature observation."""
    frame_id: int
    feature_id: int
    px: tuple          # (u, v) level-0 pixel
    level: int
    point_id: int      # map point index, -1 if none
    type: int          # FEATURE_CORNER / FEATURE_EDGELET


@dataclasses.dataclass
class NbvTrajectory:
    """svo_msgs/NbvTrajectory equivalent: a candidate trajectory for
    next-best-view planning (a sequence of stamped poses)."""
    timestamps: List[float]
    positions: List[tuple]      # (x, y, z) world
    orientations: List[tuple]   # quaternions (w, x, y, z)


def features_from_frame(frame, max_n: int = 1000) -> List[FeatureMsg]:
    """FeatureMsg records of a FrameState's valid slots."""
    px = _np(frame.feat_px)
    lvl = _np(frame.feat_level)
    pid = _np(frame.feat_point)
    typ = _np(frame.feat_type)
    fid = int(frame.frame_id)
    return [FeatureMsg(fid, int(i), (float(px[i, 0]), float(px[i, 1])),
                       int(lvl[i]), int(pid[i]), int(typ[i]))
            for i in np.nonzero(_np(frame.feat_valid))[0][:max_n]]
