"""The VO pipeline: the stage machine on the host.

Port of ``rpg_svo_tpu/core/pipeline.py`` (FrameHandlerMono /
FrameHandlerBase, svo/src/frame_handler_mono.cpp, frame_handler_base.cpp).
The per-frame control (stages, keyframe policy, failures,
relocalization) is host Python, as in JAX and the reference, and branches
on scalars it reads from the device (``int(...)``, ``bool(...)``); each
stage's arithmetic is the port's torch ops and kernels on the handler's
device.  ``FrameHandler`` differs from the fused step (``core/fused.py``)
in what runs: the depth filter updates only on due frames and with no
work gate, keyframe stages run only on keyframes, the reprojector's
attempt budget is the default factor, and relocalization aligns raw
keyframe levels (``sparse_img_align_raw``).

Stages (frame_handler_base.h:45-51): paused, first, second, default,
relocalizing.  Tracking quality (frame_handler_base.cpp:157-171):
insufficient below ``quality_min_fts`` matches, bad when the match count
dropped by more than ``quality_max_drop_fts``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from rpg_svo_tpu_torch import resolve_device
from rpg_svo_tpu_torch.config import Config
from rpg_svo_tpu_torch.core import depth_filter as df
from rpg_svo_tpu_torch.core import initialization as init_mod
from rpg_svo_tpu_torch.core import map as svomap
from rpg_svo_tpu_torch.core.frame import (
    FrameState, frame_from_pad, make_frame, scene_depth)
from rpg_svo_tpu_torch.core.fused import (
    _structure_opt_fused, frame_feature_cap, seed_first_frame_with_depth)
from rpg_svo_tpu_torch.core.local_ba import (
    run_global_ba, run_local_ba, run_two_view_ba)
from rpg_svo_tpu_torch.core.map import TYPE_CANDIDATE, TYPE_UNKNOWN, MapState
from rpg_svo_tpu_torch.core.reprojector import (
    _cell_perm, candidate_bookkeeping, grid_select, match_cells,
    project_points)
from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.ops.detector import cell_index, grid_dims
from rpg_svo_tpu_torch.ops.patches import extract_tiles
from rpg_svo_tpu_torch.ops.pose_opt import optimize_pose
from rpg_svo_tpu_torch.ops.pyramid import pyramid_shapes
from rpg_svo_tpu_torch.ops.sparse_align import (
    sparse_img_align, sparse_img_align_raw)
from rpg_svo_tpu_torch.ops.tiles import PaddedPyramid, padded_layout

STAGE_PAUSED = "paused"
STAGE_FIRST_FRAME = "first"
STAGE_SECOND_FRAME = "second"
STAGE_DEFAULT_FRAME = "default"
STAGE_RELOCALIZING = "relocalizing"

RESULT_NO_KEYFRAME = "no_keyframe"
RESULT_IS_KEYFRAME = "keyframe"
RESULT_FAILURE = "failure"

QUALITY_GOOD = "good"
QUALITY_BAD = "bad"
QUALITY_INSUFFICIENT = "insufficient"


class _StageTimer:
    """Wall-clock per-stage timers with the reference's SVO_TRACE names
    (frame_handler_base.cpp:46-74).  On the card every mark waits for the
    device (``torch.cuda.synchronize``, where JAX blocks on the stage's
    outputs), so a stage's time is its device and dispatch cost; ``syncs``
    counts those waits."""

    def __init__(self, info: dict, device: torch.device):
        self.info = info
        self.device = device
        self.syncs = 0
        self.t = time.perf_counter()

    def mark(self, name: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.syncs += 1
        now = time.perf_counter()
        self.info[name] = self.info.get(name, 0.0) + (now - self.t)
        self.t = now

    def skip(self):
        """Reset the reference point without attributing elapsed time."""
        self.t = time.perf_counter()


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index, without reading it to the host."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def _kf_policy(m: MapState, T_cur: SE3, cam, depth_mean: torch.Tensor,
               kfselect_mindist: float):
    """needNewKf (frame_handler_mono.cpp:304-315): a new keyframe unless
    an overlapping keyframe lies within the depth-weighted box.  Returns
    (need_kf, overlap (K,))."""
    overlap = svomap.overlapping_kfs(m.kf, T_cur, cam)
    rel = torch.abs(T_cur.apply(svomap.kf_positions(m.kf))) / depth_mean
    close = (rel[:, 0] < kfselect_mindist) \
        & (rel[:, 1] < kfselect_mindist * 0.8) \
        & (rel[:, 2] < kfselect_mindist * 1.3)
    return ~torch.any(overlap & close), overlap


def _occupied_cells(feat_px, feat_valid, grid_size: int, ncx: int,
                    ncy: int) -> torch.Tensor:
    """(C,) bool: cells holding a valid feature."""
    cells = cell_index(feat_px, grid_size, ncx, ncy).to(torch.int64)
    return torch.zeros((ncx * ncy,), dtype=torch.int32,
                       device=feat_px.device).scatter_reduce(
        0, cells, feat_valid.to(torch.int32), reduce="amax",
        include_self=True) > 0


class FrameHandler:
    """The host-side pipeline (FrameHandlerMono).  Runs on ``cuda``
    unless ``device`` names another."""

    def __init__(self, cam, cfg: Config = Config(), img_shape=(480, 752),
                 device=None):
        self.device = resolve_device(device)
        self.cam = cam
        self.cfg = cfg
        self.img_shape = tuple(img_shape)
        self.n_levels = cfg.n_levels_total
        self.shapes = pyramid_shapes(self.img_shape, self.n_levels)
        Ws, Hs, _ = padded_layout(self.shapes)
        self.pyr_shape = (Hs, Ws)
        self.ncx, self.ncy = grid_dims(img_shape[1], img_shape[0],
                                       cfg.grid_size)
        self.n_cells = self.ncx * self.ncy
        self.feat_cap = frame_feature_cap(self.n_cells, cfg.max_fts)
        # the fixed shuffled cell order of the spatially fair compaction
        self._cell_perm = _cell_perm(self.n_cells, str(self.device))
        self.map = self._empty_map()
        self.stage = STAGE_PAUSED
        self.quality = QUALITY_GOOD
        self.last_frame: Optional[FrameState] = None
        self.next_id = 0
        self.num_obs_last = 0
        self.log = []          # per-frame trace dicts (SVO_TRACE schema)
        self.initializer = init_mod.KltHomographyInit(cam, cfg,
                                                      self.n_cells)
        self._init_frame0: Optional[FrameState] = None   # bootstrap frame 0
        self._timer = None
        self.set_start()

    def _empty_map(self) -> MapState:
        cfg = self.cfg
        return svomap.init_map(cfg.max_kfs_pool, self.n_cells,
                               cfg.max_points, cfg.max_obs_per_point,
                               cfg.max_seeds, self.pyr_shape,
                               device=self.device)

    # -- control (frame_handler_base.h start/reset) -----------------------
    def set_start(self):
        self.stage = STAGE_FIRST_FRAME

    def reset(self):
        self.map = self._empty_map()
        self.stage = STAGE_FIRST_FRAME
        self.last_frame = None
        self.num_obs_last = 0

    def _image(self, img) -> torch.Tensor:
        return torch.as_tensor(img, dtype=torch.float32, device=self.device)

    def _frame(self, img, timestamp: float) -> FrameState:
        frame = make_frame(self._image(img), self.n_levels, self.feat_cap,
                           self.next_id, timestamp)
        self.next_id += 1
        return frame

    def _compact_feats(self, good: torch.Tensor):
        """Up to feat_cap set entries of good (C,) in the shuffled cell
        order: (idx (F,), valid (F,))."""
        sel_p, sv = svomap.mask_compact(good[self._cell_perm], self.feat_cap)
        return self._cell_perm[sel_p], sv

    # -- benchmark seeding (BenchmarkNode / setFirstFrame) ----------------
    def set_first_frame_with_depth(self, img, T_f_w: SE3, depth_map,
                                   timestamp: float = 0.0) -> FrameState:
        """Seed the map from a ground-truth depth map on the first frame
        (benchmark_node.cpp:216-234): GOOD points at the true depth of the
        detected corners, the frame a keyframe, seeds in the cells left
        free."""
        dev = self.device
        st = seed_first_frame_with_depth(
            self._image(img), SE3(T_f_w.R.to(dev), T_f_w.t.to(dev)),
            self._image(depth_map), self.cam, self.cfg, self.img_shape,
            device=dev, frame_id=self.next_id, m=self.map)
        frame = frame_from_pad(st.pad, self.feat_cap, self.next_id,
                               timestamp, SE3(st.R, st.t))._replace(
            feat_px=st.feat_px, feat_f=st.feat_f, feat_level=st.feat_level,
            feat_point=st.feat_point, feat_valid=st.feat_valid)
        self.next_id += 1
        self.map = st.m
        self.last_frame = frame
        self.num_obs_last = int(st.num_obs_last)
        self.stage = STAGE_DEFAULT_FRAME
        return frame

    # -- main entry -------------------------------------------------------
    def add_image(self, img, timestamp: float = 0.0) -> dict:
        t0 = time.perf_counter()
        info = {"timestamp": timestamp, "stage": self.stage,
                "frame_id": self.next_id}
        timer = self._timer = _StageTimer(info, self.device)
        frame = self._frame(img, timestamp)
        timer.mark("pyramid_creation")
        if self.stage == STAGE_DEFAULT_FRAME:
            res, frame, info = self._process_frame(frame, info)
        elif self.stage == STAGE_RELOCALIZING:
            res, frame, info = self._relocalize(frame, info)
        elif self.stage == STAGE_FIRST_FRAME:
            res, frame, info = self._process_first_frame(frame, info)
        elif self.stage == STAGE_SECOND_FRAME:
            res, frame, info = self._process_second_frame(frame, info)
        else:
            raise RuntimeError(f"stage {self.stage}")
        if res == RESULT_FAILURE and self.stage == STAGE_DEFAULT_FRAME:
            self.stage = STAGE_RELOCALIZING
        self.last_frame = frame
        info["result"] = res
        info["proc_time"] = time.perf_counter() - t0
        info["timer_syncs"] = timer.syncs
        self.log.append(info)
        return info

    # -- bootstrap stages (processFirstFrame / processSecondFrame) --------
    def _process_first_frame(self, frame: FrameState, info):
        frame = frame.with_pose(SE3.identity(device=self.device))
        if self.initializer.add_first_frame(frame.pyr) != \
                init_mod.RESULT_SUCCESS:
            return RESULT_NO_KEYFRAME, frame, info
        self._init_frame0 = frame
        self.stage = STAGE_SECOND_FRAME
        return RESULT_IS_KEYFRAME, frame, info

    def _process_second_frame(self, frame: FrameState, info):
        res, tv = self.initializer.add_second_frame(frame.pyr,
                                                    seed=info["frame_id"])
        if res == init_mod.RESULT_FAILURE:
            self.initializer.reset()
            self.stage = STAGE_FIRST_FRAME
            return RESULT_FAILURE, frame, info
        if res == init_mod.RESULT_NO_KEYFRAME:
            return RESULT_NO_KEYFRAME, frame, info

        dev = self.device
        cfg = self.cfg
        f0 = self._init_frame0
        frame = frame.with_pose(tv.T_cur_ref)   # world = the first camera
        C = self.n_cells
        lvl0 = torch.zeros((C,), dtype=torch.int32, device=dev)
        feat_idx = torch.arange(C, dtype=torch.int32, device=dev)

        # keyframe 0 (the world origin) with the inlier features
        tile0, txy0 = extract_tiles(f0.pad, tv.px_ref, lvl0)
        m, slot0 = svomap.add_keyframe(
            self.map, f0.pad.stack, SE3.identity(device=dev), f0.frame_id,
            tv.px_ref, tv.f_ref, lvl0,
            torch.full((C,), -1, dtype=torch.int32, device=dev), tv.inlier,
            torch.linalg.vector_norm(tv.p_w, dim=-1), feat_tile=tile0,
            feat_tile_xy0=txy0)
        # points of UNKNOWN quality, originating on keyframe 0
        pt, ids = svomap.alloc_points(
            m.pt, tv.p_w, TYPE_UNKNOWN, slot0.expand(C), tv.px_ref, tv.f_ref,
            lvl0, tv.inlier, orig_tile=tile0, orig_tile_xy0=txy0)
        pt = svomap.add_point_observations(pt, ids, slot0.expand(C),
                                           feat_idx, tv.inlier)
        fp = torch.where(tv.inlier, ids, torch.full_like(ids, -1))
        kf = m.kf._replace(feat_point=svomap.set_rows(
            m.kf.feat_point, slot0.reshape(1), fp[None],
            (slot0 >= 0).reshape(1)))
        self.map = m._replace(pt=pt, kf=kf)

        # keyframe 1 (this frame)
        depth1 = torch.linalg.vector_norm(tv.T_cur_ref.apply(tv.p_w), dim=-1)
        tile1, txy1 = extract_tiles(frame.pad, tv.px_cur, lvl0)
        m, slot1 = svomap.add_keyframe(
            self.map, frame.pad.stack, tv.T_cur_ref, frame.frame_id,
            tv.px_cur, tv.f_cur, lvl0, fp, tv.inlier, depth1,
            feat_tile=tile1, feat_tile_xy0=txy1)
        pt = svomap.add_point_observations(m.pt, ids, slot1.expand(C),
                                           feat_idx, tv.inlier)
        self.map = m._replace(pt=pt)

        # two-view BA of the pair when BA is on (ba::twoViewBA, the
        # reference's USE_BUNDLE_ADJUSTMENT build)
        if cfg.loba_num_iter > 0:
            self.map = svomap.scrub_dead_references(run_two_view_ba(
                self.map, slot0, slot1, cfg.loba_robust_huber_width,
                cfg.loba_thresh, self.cam.fx, n_iter=cfg.loba_num_iter))
            frame = frame.with_pose(SE3(_row(self.map.kf.R, slot1),
                                        _row(self.map.kf.t, slot1)))

        fsel, fsv = self._compact_feats(tv.inlier)
        frame = frame._replace(
            feat_px=tv.px_cur[fsel], feat_f=tv.f_cur[fsel],
            feat_level=lvl0[fsel],
            feat_point=torch.where(fsv, ids[fsel], torch.full_like(
                ids[fsel], -1)), feat_valid=fsv)

        # depth-filter seeds on keyframe 1
        depth_mean, depth_min = scene_depth(frame.T_f_w, frame.feat_point,
                                            frame.feat_valid,
                                            self.map.pt.pos)
        occupied = _occupied_cells(frame.feat_px, frame.feat_valid,
                                   cfg.grid_size, self.ncx, self.ncy)
        self.map = df.init_seeds(
            self.map, slot1, frame.pad, self.cam, occupied, depth_mean,
            0.5 * depth_min, cell_size=cfg.grid_size,
            min_score=cfg.triang_min_corner_score,
            det_levels=cfg.n_pyr_levels, max_per_kf=cfg.max_seeds_per_kf)
        n_inl = int(torch.sum(tv.inlier))
        self.num_obs_last = n_inl
        self.initializer.reset()
        self.stage = STAGE_DEFAULT_FRAME
        info["init_inliers"] = n_inl
        return RESULT_IS_KEYFRAME, frame, info

    # -- the tracking stages ----------------------------------------------
    def _track(self, frame: FrameState, info):
        """Sparse alignment, reprojection and pose refinement: (n_matches,
        n_edges, frame with its pose and feature table)."""
        cfg = self.cfg
        last = self.last_frame
        P = self.map.pt.pos.shape[0]
        timer = self._timer
        timer.skip()
        pid = torch.clamp(last.feat_point, 0, P - 1).to(torch.int64)
        depth = torch.linalg.vector_norm(
            last.T_f_w.apply(self.map.pt.pos[pid]), dim=-1)
        fvalid = last.feat_valid & (last.feat_point >= 0) \
            & (self.map.pt.ptype[pid] != svomap.TYPE_DELETED)
        align = sparse_img_align(
            last.pad, frame.pad, self.cam, SE3.identity(device=self.device),
            last.feat_px, last.feat_f, depth, fvalid,
            max_level=cfg.klt_max_level, min_level=cfg.klt_min_level,
            n_iter=cfg.img_align_n_iter, eps=cfg.img_align_eps,
            robust=cfg.img_align_robust)
        T_cur = align.T_cur_ref * last.T_f_w
        frame = frame.with_pose(T_cur)
        info["img_align_n_tracked"] = int(align.n_tracked)
        timer.mark("sparse_img_align")

        # reprojection in stages, each with its own timer
        # (frame_handler_base.cpp:51-57): point projection and grid
        # selection are reproject_kfs, the candidate pass is
        # reproject_candidates, the per-cell matching is feature_align
        px_all, vis0 = project_points(self.map.pt, T_cur, self.cam)
        timer.mark("reproject_kfs")
        n_fail, ptype, visible = candidate_bookkeeping(self.map.pt, vis0)
        timer.mark("reproject_candidates")
        has, sel_pt = grid_select(px_all, visible, ptype, cfg.grid_size,
                                  self.ncx, self.ncy, self.feat_cap)
        timer.mark("reproject_kfs")
        pt, rep = match_cells(self.map, T_cur, self.cam, n_fail, ptype, has,
                              sel_pt, cfg.n_pyr_levels - 1, frame.pad,
                              self.feat_cap)
        timer.mark("feature_align")
        self.map = svomap.scrub_dead_references(self.map._replace(pt=pt))
        info["repr_n_mps"] = int(rep.n_trials)
        n_matches = int(rep.n_matches)
        info["repr_n_new_references"] = n_matches
        info["reproject"] = (info.get("reproject_kfs", 0.0)
                             + info.get("reproject_candidates", 0.0)
                             + info.get("feature_align", 0.0))
        timer.skip()
        frame = frame._replace(
            feat_px=rep.feat_px, feat_f=self.cam.cam2world(rep.feat_px),
            feat_level=rep.feat_level, feat_point=rep.feat_point,
            feat_valid=rep.feat_valid, feat_type=rep.feat_type,
            feat_grad=rep.feat_grad)
        if n_matches < cfg.quality_min_fts:
            return n_matches, 0, frame

        pid = torch.clamp(frame.feat_point, 0, P - 1).to(torch.int64)
        pres = optimize_pose(
            frame.T_f_w, self.map.pt.pos[pid], frame.feat_f,
            frame.feat_level, frame.feat_valid, self.cam.fx,
            reproj_thresh=cfg.poseoptim_thresh,
            n_iter=cfg.poseoptim_num_iter)
        frame = frame.with_pose(pres.T_f_w)._replace(feat_valid=pres.inliers)
        info["sfba_thresh"] = float(pres.estimated_scale)
        info["sfba_error_init"] = float(pres.error_init)
        info["sfba_error_final"] = float(pres.error_final)
        n_edges = int(pres.n_obs)
        info["sfba_n_edges_final"] = n_edges
        timer.mark("pose_optimizer")
        return n_matches, n_edges, frame

    def _update_seeds(self, frame: FrameState):
        cfg = self.cfg
        self.map, stats = df.update_seeds(
            self.map, frame.pad, frame.T_f_w, self.cam,
            max_n_kfs=cfg.df_max_kf_age,
            conv_thresh=cfg.seed_convergence_sigma2_thresh,
            max_steps=cfg.epi_max_steps, update_k=cfg.df_update_k,
            short_steps=cfg.epi_short_steps, long_k=cfg.epi_long_k,
            max_level=cfg.n_pyr_levels - 1, scan_rows=cfg.epi_scan_rows)
        return stats

    def _process_frame(self, frame: FrameState, info):
        cfg = self.cfg
        dev = self.device
        last = self.last_frame
        n_matches, n_edges, frame = self._track(frame, info)
        if n_matches < cfg.quality_min_fts:
            self.quality = QUALITY_INSUFFICIENT
            # no jump to an unreliable pose
            return RESULT_FAILURE, frame.with_pose(last.T_f_w), info
        if n_edges < 20:
            return RESULT_FAILURE, frame, info

        timer = self._timer
        timer.skip()
        self.map = _structure_opt_fused(
            self.map, frame.T_f_w, frame.frame_id, frame.feat_point,
            frame.feat_valid, cfg.structureoptim_max_pts,
            cfg.structureoptim_num_iter, torch.ones((), dtype=torch.bool,
                                                    device=dev))
        timer.mark("point_optimizer")

        self._set_quality(n_edges)
        if self.quality == QUALITY_INSUFFICIENT:
            return RESULT_FAILURE, frame.with_pose(last.T_f_w), info
        self.num_obs_last = n_edges

        depth_mean, depth_min = scene_depth(frame.T_f_w, frame.feat_point,
                                            frame.feat_valid,
                                            self.map.pt.pos)
        need_kf, _ = _kf_policy(self.map, frame.T_f_w, self.cam, depth_mean,
                                cfg.kfselect_mindist)
        if not bool(need_kf) or self.quality == QUALITY_BAD:
            if cfg.df_update_every <= 1 \
                    or info["frame_id"] % cfg.df_update_every == 0:
                info["n_seeds"] = int(self._update_seeds(frame).n_seeds)
            return RESULT_NO_KEYFRAME, frame, info

        # ------- new keyframe -------
        info["is_keyframe"] = True
        C = self.n_cells
        F = frame.feat_px.shape[0]
        P = self.map.pt.pos.shape[0]
        ktile, ktxy0 = extract_tiles(frame.pad, frame.feat_px,
                                     frame.feat_level)
        pid = torch.clamp(frame.feat_point, 0, P - 1).to(torch.int64)
        kdepth = torch.linalg.vector_norm(
            frame.T_f_w.apply(self.map.pt.pos[pid]), dim=-1)
        padC = svomap.pad_rows
        m, slot = svomap.add_keyframe(
            self.map, frame.pad.stack, frame.T_f_w, frame.frame_id,
            padC(frame.feat_px, C, 0), padC(frame.feat_f, C, 0),
            padC(frame.feat_level, C, 0), padC(frame.feat_point, C, -1),
            padC(frame.feat_valid, C, False), padC(kdepth, C, 1.0),
            feat_type=padC(frame.feat_type, C, 0),
            feat_grad=padC(frame.feat_grad, C, 0),
            feat_tile=padC(ktile, C, 0), feat_tile_xy0=padC(ktxy0, C, -1))
        # point->addFrameRef for every matched feature; bound candidates
        # become UNKNOWN (only valid rows write)
        bind = frame.feat_valid & (frame.feat_point >= 0)
        pt = svomap.add_point_observations(
            m.pt, frame.feat_point, slot.expand(F),
            torch.arange(F, dtype=torch.int32, device=dev), frame.feat_valid)
        hit = svomap.set_rows(torch.zeros((P,), dtype=torch.bool, device=dev),
                              pid, bind, bind)
        ptype = torch.where(hit & (pt.ptype == TYPE_CANDIDATE),
                            torch.full_like(pt.ptype, TYPE_UNKNOWN), pt.ptype)
        self.map = m._replace(pt=pt._replace(ptype=ptype))

        if cfg.loba_num_iter > 0:
            timer.skip()
            self.map = run_local_ba(
                self.map, slot, cfg.loba_robust_huber_width, cfg.loba_thresh,
                self.cam.fx, n_iter=cfg.loba_num_iter,
                core_n_kfs=cfg.core_n_kfs)
            frame = frame.with_pose(SE3(_row(self.map.kf.R, slot),
                                        _row(self.map.kf.t, slot)))
            timer.mark("local_ba")

        # seeds: update against the keyframe, then new ones in its free
        # cells
        self._update_seeds(frame)
        occupied = _occupied_cells(frame.feat_px, frame.feat_valid,
                                   cfg.grid_size, self.ncx, self.ncy)
        self.map = df.init_seeds(
            self.map, slot, frame.pad, self.cam, occupied, depth_mean,
            0.5 * depth_min, cell_size=cfg.grid_size,
            min_score=cfg.triang_min_corner_score,
            det_levels=cfg.n_pyr_levels, max_per_kf=cfg.max_seeds_per_kf)
        info["n_seeds"] = int(torch.sum(self.map.seed.active))

        # the map cap: drop the furthest keyframe, never the new one
        if cfg.max_n_kfs > 2 and \
                int(svomap.n_active_kfs(self.map)) >= cfg.max_n_kfs:
            far = svomap.furthest_kf(self.map.kf, frame.T_f_w.inverse().t)
            if int(far) != int(slot):
                self.map = svomap.delete_keyframe(self.map, far)
        return RESULT_IS_KEYFRAME, frame, info

    def _relocalize(self, frame: FrameState, info):
        """relocalizeFrame (frame_handler_mono.cpp:237-265): align against
        the closest keyframe; when enough features track, run the normal
        frame from it and leave relocalization on success."""
        kf = self.map.kf
        ref = svomap.closest_kf(kf, self.last_frame.T_f_w.inverse().t)
        if not bool(_row(kf.active, ref)):
            return RESULT_FAILURE, frame, info
        P = self.map.pt.pos.shape[0]
        fp = _row(kf.feat_point, ref)
        pid = torch.clamp(fp, 0, P - 1).to(torch.int64)
        T_kf = SE3(_row(kf.R, ref), _row(kf.t, ref))
        depth = torch.linalg.vector_norm(T_kf.apply(self.map.pt.pos[pid]),
                                         dim=-1)
        fvalid = _row(kf.feat_valid, ref) & (fp >= 0)
        kf_pad = PaddedPyramid.from_stack(_row(kf.flat_pyr, ref), self.shapes)
        pyr = kf_pad.levels()
        align = sparse_img_align_raw(
            pyr, frame.pyr, self.cam, SE3.identity(device=self.device),
            _row(kf.feat_px, ref), _row(kf.feat_f, ref), depth, fvalid,
            max_level=self.cfg.klt_max_level,
            min_level=self.cfg.klt_min_level)
        if int(align.n_tracked) <= 30:
            return RESULT_FAILURE, frame, info
        T_last_saved = self.last_frame.T_f_w
        # the keyframe as the last frame; its detector-dense row compacts
        # into the frame table
        if fvalid.shape[0] != self.feat_cap:
            sel, sv = self._compact_feats(fvalid)
        else:
            sel = torch.arange(self.feat_cap, device=self.device)
            sv = fvalid
        saved_last = self.last_frame
        self.last_frame = FrameState(
            pyr=pyr, pad=kf_pad, flat=kf_pad.flat_view(), R=T_kf.R, t=T_kf.t,
            frame_id=_row(kf.frame_id, ref), timestamp=frame.timestamp,
            feat_px=_row(kf.feat_px, ref)[sel],
            feat_f=_row(kf.feat_f, ref)[sel],
            feat_level=_row(kf.feat_level, ref)[sel],
            feat_point=torch.where(sv, fp[sel], torch.full_like(fp[sel], -1)),
            feat_valid=sv, feat_type=_row(kf.feat_type, ref)[sel],
            feat_grad=_row(kf.feat_grad, ref)[sel])
        res, frame, info = self._process_frame(frame, info)
        if res != RESULT_FAILURE:
            self.stage = STAGE_DEFAULT_FRAME
        else:
            frame = frame.with_pose(T_last_saved)
            self.last_frame = saved_last
        return res, frame, info

    # -- public API of FrameHandlerMono -----------------------------------
    def last_processing_time(self) -> float:
        return self.log[-1]["proc_time"] if self.log else 0.0

    def tracking_quality(self) -> str:
        return self.quality

    def global_ba(self, n_iter: int | None = None):
        """ba::globalBA over the whole keyframe map, on demand."""
        cfg = self.cfg
        self.map = svomap.scrub_dead_references(run_global_ba(
            self.map, cfg.loba_robust_huber_width, cfg.loba_thresh,
            cfg.poseoptim_thresh, self.cam.fx,
            n_iter=n_iter if n_iter is not None
            else max(cfg.loba_num_iter, 10)))

    def relocalize_frame_at_pose(self, kf_frame_id: int, T_f_kf: SE3, img,
                                 timestamp: float = 0.0) -> bool:
        """relocalizeFrameAtPose (frame_handler_mono.cpp:267-283): resume
        tracking against a known keyframe with a pose prior."""
        kf = self.map.kf
        slots = np.flatnonzero(kf.active.cpu().numpy()
                               & (kf.frame_id.cpu().numpy() == kf_frame_id))
        if len(slots) == 0:
            return False
        slot = int(slots[0])
        info = {"frame_id": self.next_id, "timestamp": timestamp,
                "stage": STAGE_RELOCALIZING}
        self._timer = _StageTimer(info, self.device)
        frame = self._frame(img, timestamp)
        T_f_kf = SE3(T_f_kf.R.to(self.device), T_f_kf.t.to(self.device))
        frame = frame.with_pose(T_f_kf * SE3(kf.R[slot], kf.t[slot]))
        saved_stage = self.stage
        self.stage = STAGE_RELOCALIZING
        res, frame, info = self._relocalize(frame, info)
        self.last_frame = frame
        if res != RESULT_FAILURE:
            self.stage = STAGE_DEFAULT_FRAME
            return True
        self.stage = saved_stage
        return False

    def get_seeds_snapshot(self) -> dict:
        """The active seeds as numpy arrays (DepthFilter::getSeedsCopy)."""
        s = self.map.seed
        act = s.active.cpu().numpy()
        return {k: getattr(s, k).cpu().numpy()[act]
                for k in ("kf_slot", "px", "mu", "sigma2", "a", "b")}

    def dense_input(self, kf_slot: int):
        """DenseInput export (visualizer.cpp:269-314): the keyframe image,
        its pose and the depth range of its points; None for a free
        slot."""
        kf = self.map.kf
        if not bool(kf.active[kf_slot]):
            return None
        h, w = self.shapes[0]
        img = kf.flat_pyr[kf_slot].reshape(self.pyr_shape)[:h, :w] \
            .cpu().numpy()
        pid = kf.feat_point[kf_slot]
        ok = (kf.feat_valid[kf_slot] & (pid >= 0)).cpu().numpy()
        T = SE3(kf.R[kf_slot], kf.t[kf_slot])
        zmin, zmax = 0.1, 10.0
        if ok.any():
            p = T.apply(self.map.pt.pos[torch.clamp(
                pid, 0, self.map.pt.pos.shape[0] - 1).to(torch.int64)])
            z = p.cpu().numpy()[ok, 2]
            z = z[z > 0]
            if len(z):
                zmin, zmax = float(z.min()), float(z.max())
        return {"image": img, "T_w_f": T.inverse(), "min_depth": zmin,
                "max_depth": zmax, "frame_id": int(kf.frame_id[kf_slot])}

    def _set_quality(self, num_obs: int):
        self.quality = QUALITY_GOOD
        if num_obs < self.cfg.quality_min_fts:
            self.quality = QUALITY_INSUFFICIENT
        if self.num_obs_last - num_obs > self.cfg.quality_max_drop_fts:
            self.quality = QUALITY_BAD
