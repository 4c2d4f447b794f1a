"""Steps of the plain reference from a given state.

The reference seeds itself from the benchmark's inputs (frame 0, its pose
and its ground-truth depth), which is the start the check compares.  It
cannot run a whole window's chain in the time of a run (the eager body
takes about 7x the program's time per frame), so for each sampled frame
it follows the program step by step: it takes the state the program held
before the frame as a flat list of tensors, lays it out in its own types
(the treespec of its own seeded state), steps it once on the same uint8
image, and hands back the pose and the map.  It imports torch, numpy and
its own frozen copy only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from svo_bench.reference.svo import config as rconfig
from svo_bench.reference.svo.core import fused, pipeline
from svo_bench.reference.svo.geometry.cameras import PinholeCamera
from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.ops.detector import grid_dims

# the handler's host fields that a step reads besides its map and frame
HANDLER_FIELDS = ("stage", "quality", "num_obs_last", "next_id")


class Pose(NamedTuple):
    R_wc: torch.Tensor      # (3, 3)
    t_wc: torch.Tensor      # (3,)


def pose_of(R_fw: torch.Tensor, t_fw: torch.Tensor) -> Pose:
    """T_w_c of a frame from its T_f_w."""
    R_wc = R_fw.transpose(-1, -2)
    return Pose(R_wc, -(R_wc @ t_fw[..., None])[..., 0])


def round_bf16(tree):
    """Every floating tensor of ``tree`` rounded to bfloat16 and back: the
    low-precision control's state and image."""
    return pytree.tree_map(
        lambda x: x.to(torch.bfloat16).to(x.dtype)
        if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
        tree)


class Reference:
    """The reference of one configuration file on ``device``."""

    def __init__(self, cfg_file: dict, device):
        self.device = torch.device(device)
        self.cfg = getattr(rconfig, f"{cfg_file['preset']}_preset")(
            **cfg_file["overrides"])
        c = cfg_file["camera"]
        self.cam = PinholeCamera.make(c["width"], c["height"], c["fx"],
                                      c["fy"], c["cx"], c["cy"])
        self.img_shape = tuple(cfg_file["img_shape"])
        self.ncx, self.ncy = grid_dims(self.img_shape[1], self.img_shape[0],
                                       self.cfg.grid_size)
        self._spec = {}

    def _image(self, img_u8: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(img_u8, dtype=torch.float32,
                               device=self.device)

    def _T_f_w(self, R_wc: np.ndarray, t_wc: np.ndarray) -> SE3:
        R = torch.as_tensor(R_wc.T, dtype=torch.float32, device=self.device)
        t = torch.as_tensor(-R_wc.T @ t_wc, dtype=torch.float32,
                            device=self.device)
        return SE3(R, t)

    # -- the start ----------------------------------------------------------
    def seed_handler(self, img_u8, R_wc, t_wc, depth) -> pipeline.FrameHandler:
        """A handler seeded from frame 0 with its ground-truth depth
        (benchmark_node.cpp:216-234)."""
        fh = pipeline.FrameHandler(self.cam, self.cfg, self.img_shape,
                                   device=self.device)
        fh.set_first_frame_with_depth(self._image(img_u8),
                                      self._T_f_w(R_wc, t_wc),
                                      depth.to(self.device))
        self._spec["handler"] = pytree.tree_structure(
            (fh.map, fh.last_frame))
        self._handler = fh
        return fh

    def seed_step(self, img_u8, R_wc, t_wc, depth) -> fused.VOState:
        """The fused step's state seeded from frame 0."""
        st = fused.seed_first_frame_with_depth(
            self._image(img_u8), self._T_f_w(R_wc, t_wc),
            depth.to(self.device), self.cam, self.cfg, self.img_shape,
            device=self.device)
        self._spec["step"] = pytree.tree_structure(st)
        return st

    # -- one step from the program's state -----------------------------------
    def _adopt(self, kind: str, leaves: list, control: bool):
        spec = self._spec[kind]
        if len(leaves) != spec.num_leaves:
            raise ValueError(f"a {kind} state of {len(leaves)} leaves, the "
                             f"reference's has {spec.num_leaves}")
        tree = pytree.tree_unflatten(
            [x.clone() if isinstance(x, torch.Tensor) else x
             for x in leaves], spec)
        return round_bf16(tree) if control else tree

    def handler_step(self, leaves: list, fields: dict, img_u8,
                     control: bool = False):
        """(pose, map, result) of the handler's ``add_image`` from the
        state given as the leaves of (map, last frame) and the host
        fields."""
        fh = self._handler
        fh.map, fh.last_frame = self._adopt("handler", leaves, control)
        for k in HANDLER_FIELDS:
            setattr(fh, k, fields[k])
        img = self._image(img_u8)
        if control:
            img = round_bf16(img)
        info = fh.add_image(img)
        lf = fh.last_frame
        return pose_of(lf.R, lf.t), fh.map, info["result"]

    def chain(self, kind: str, leaves: list, fields: dict, imgs,
              control: bool = False) -> np.ndarray:
        """Positions T_w_c.t (n, 3) of n steps in a row from the state
        given as its leaves (and, for the handler, its host fields), one
        per image; with ``control`` the state is rounded to bfloat16
        before each step."""
        out = []
        if kind == "handler":
            fh = self._handler
            fh.map, fh.last_frame = self._adopt("handler", leaves, False)
            for k in HANDLER_FIELDS:
                setattr(fh, k, fields[k])
            for img_u8 in imgs:
                if control:
                    fh.map, fh.last_frame = round_bf16((fh.map,
                                                        fh.last_frame))
                fh.add_image(self._image(img_u8))
                out.append(pose_of(fh.last_frame.R, fh.last_frame.t).t_wc)
        else:
            st = self._adopt("step", leaves, False)
            for img_u8 in imgs:
                if control:
                    st = round_bf16(st)
                st, o = fused._vo_step(st, self._image(img_u8), self.cam,
                                       self.cfg, self.ncx, self.ncy,
                                       self.img_shape, inplace=False)
                out.append(o.t_wc)
        return torch.stack(out).double().cpu().numpy()

    def vo_step(self, leaves: list, img_u8, control: bool = False):
        """(pose, map, keyframe) of the eager fused step from the state
        given as its leaves."""
        st = self._adopt("step", leaves, control)
        img = self._image(img_u8)
        if control:
            img = round_bf16(img)
        new, out = fused._vo_step(st, img, self.cam, self.cfg, self.ncx,
                                  self.ncy, self.img_shape, inplace=False)
        return Pose(out.R_fw.transpose(-1, -2), out.t_wc), new.m, \
            bool(out.is_keyframe)
