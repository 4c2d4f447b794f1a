"""Two-view bootstrap: KLT tracking and homography initialization.

Port of ``rpg_svo_tpu/core/initialization.py`` (initialization::
KltHomographyInit, svo/src/initialization.cpp):

- first frame: detect corners, require at least 100 (:29-41, 107-125);
- second frame: track them with pyramidal LK, require ``init_min_tracked``
  tracked and a median disparity of ``init_min_disparity`` px (:43-66,
  127-169);
- a RANSAC homography on the unit plane, at least ``init_min_inliers``
  inliers and a decomposition that explains them (:171-195);
- triangulate the inliers and scale the map so that the median scene
  depth is ``map_scale`` (:68-97).

The host reads the counts to branch, as in JAX.  The RANSAC samples are
drawn by ``ops.homography.ransac_draw`` from a CPU generator seeded by
the caller (``FrameHandler`` passes the frame id, as JAX keys its draw).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from svo_bench.reference.svo.geometry.cameras import project2d
from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.geometry.triangulation import triangulate_midpoint
from svo_bench.reference.svo.ops import homography
from svo_bench.reference.svo.ops.detector import detect_features
from svo_bench.reference.svo.ops.lk import track_klt
from svo_bench.reference.svo.ops.pyramid import build_lk_pyramid
from svo_bench.reference.svo.ops.robust import masked_median

RESULT_SUCCESS = "success"
RESULT_NO_KEYFRAME = "no_keyframe"
RESULT_FAILURE = "failure"
N_RANSAC = 256


class InitState(NamedTuple):
    px_ref: torch.Tensor     # (C, 2) corners detected on the first frame
    f_ref: torch.Tensor      # (C, 3)
    level_ref: torch.Tensor  # (C,) int32
    valid: torch.Tensor      # (C,) bool


class TwoViewResult(NamedTuple):
    T_cur_ref: SE3           # relative pose, scaled
    px_ref: torch.Tensor     # (C, 2)
    px_cur: torch.Tensor     # (C, 2) tracked
    f_ref: torch.Tensor
    f_cur: torch.Tensor
    p_w: torch.Tensor        # (C, 3) triangulated; the first frame is world
    inlier: torch.Tensor     # (C,)


class KltHomographyInit:
    """Host-side bootstrap state machine (the reference class)."""

    def __init__(self, cam, cfg, n_cells: int):
        self.cam = cam
        self.cfg = cfg
        self.n_cells = n_cells
        self.state: Optional[InitState] = None
        self.ref_pyr = None

    def reset(self):
        self.state = None
        self.ref_pyr = None

    def add_first_frame(self, pyr) -> str:
        dev = pyr[0].device
        det = detect_features(pyr[:self.cfg.n_pyr_levels],
                              torch.zeros((self.n_cells,), dtype=torch.bool,
                                          device=dev), self.cfg.grid_size)
        if int(torch.sum(det["valid"])) < 100:
            return RESULT_NO_KEYFRAME
        self.state = InitState(det["px"], self.cam.cam2world(det["px"]),
                               det["level"], det["valid"])
        self.ref_pyr = build_lk_pyramid(pyr[0], len(pyr))
        return RESULT_SUCCESS

    def add_second_frame(self, pyr, seed: int = 0):
        """(result, TwoViewResult or None); ``seed`` seeds the RANSAC
        draw's generator."""
        cfg = self.cfg
        st = self.state
        lk_pyr = build_lk_pyramid(pyr[0], len(pyr))
        px_cur, ok = track_klt(self.ref_pyr, lk_pyr, st.px_ref, st.valid,
                               halfwin=15, max_level=4)
        tracked = st.valid & ok
        disp = torch.linalg.vector_norm(px_cur - st.px_ref, dim=-1)
        if int(torch.sum(tracked)) < cfg.init_min_tracked:
            return RESULT_FAILURE, None
        if float(masked_median(disp, tracked)) < cfg.init_min_disparity:
            return RESULT_NO_KEYFRAME, None

        f_cur = self.cam.cam2world(px_cur)
        gen = torch.Generator().manual_seed(int(seed))
        idx = homography.ransac_draw(tracked, N_RANSAC, gen)
        hres = homography.estimate_homography(
            project2d(st.f_ref), project2d(f_cur), tracked, idx,
            thresh=2.0 * cfg.reproj_thresh / self.cam.fx)
        if int(hres.n_inliers) < cfg.init_min_inliers \
                or not bool(hres.decomp_ok):
            return RESULT_FAILURE, None

        # triangulate in the first frame (the world until tracking starts)
        T_cur = hres.T_cur_ref
        p_w, tri_ok = triangulate_midpoint(
            SE3.identity(device=f_cur.device), T_cur.inverse(), st.f_ref,
            f_cur)
        good = hres.inliers & tri_ok
        z_cur = T_cur.apply(p_w)[..., 2]
        depth_med = masked_median(
            torch.where(good, z_cur, torch.full_like(z_cur, float("inf"))),
            good, default=1.0)
        scale = cfg.map_scale / torch.clamp(depth_med, min=1e-9)
        return RESULT_SUCCESS, TwoViewResult(
            SE3(T_cur.R, T_cur.t * scale), st.px_ref, px_cur, st.f_ref,
            f_cur, p_w * scale, good)
