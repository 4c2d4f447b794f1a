"""Local bundle adjustment over the keyframe map.

Port of ``build_local_ba_problem`` and ``run_local_ba`` from
``rpg_svo_tpu/core/local_ba.py`` (ba::localBA,
svo/src/bundle_adjustment.cpp:122-251): the new keyframe and its
``core_n_kfs`` closest active keyframes are variable, every other
keyframe stays fixed; the points seen by a variable keyframe with at least
two observations are compacted (most observations first) and solved with
them; outlier observations are pruned and points left with fewer than two
die.  The point store's observation table is the problem layout as it is.

Also ``run_two_view_ba`` (ba::twoViewBA, bundle_adjustment.cpp:41-120,
after the bootstrap) and ``run_global_ba`` (ba::globalBA, :253-343, on
demand), which solve over the whole point pool.
"""

from __future__ import annotations

import functools

import torch

from svo_bench.reference.svo.ba.schur import BAProblem, _apply_cams, solve_ba
from svo_bench.reference.svo.core import graphed
from svo_bench.reference.svo.core.map import (
    TYPE_DELETED, TYPE_UNKNOWN, MapState, kf_positions,
    mask_compact_priority, set_rows)
from svo_bench.reference.svo.geometry.cameras import project2d
from svo_bench.reference.svo.parallel.gspmd import gather_dim0, psum, shard_dim0


def _extract_observations_rows(kf, obs_kf, obs_feat, obs_valid, orig_kf,
                               orig_f, orig_level):
    """Observation rows plus the origin column as problem arrays:
    (obs_cam, obs_f, obs_level, obs_mask), each (rows, M + 1); only
    observations on active keyframes count."""
    K, F = kf.feat_f.shape[:2]
    kfs = torch.clamp(obs_kf, 0, K - 1).to(torch.int64)
    fts = torch.clamp(obs_feat, 0, F - 1).to(torch.int64)
    okf = torch.clamp(orig_kf, 0, K - 1).to(torch.int64)
    obs_cam = torch.cat([kfs, okf[:, None]], dim=1)
    obs_f = torch.cat([kf.feat_f[kfs, fts], orig_f[:, None]], dim=1)
    obs_level = torch.cat([kf.feat_level[kfs, fts], orig_level[:, None]],
                          dim=1)
    obs_mask = torch.cat([obs_valid, (orig_kf >= 0)[:, None]], dim=1) \
        & kf.active[obs_cam]
    return obs_cam.to(torch.int32), obs_f, obs_level, obs_mask


def _extract_observations(m: MapState):
    """The whole observation table plus the origin column as problem
    arrays, each (P, M + 1)."""
    pt = m.pt
    return _extract_observations_rows(m.kf, pt.obs_kf, pt.obs_feat,
                                      pt.obs_valid, pt.orig_kf, pt.orig_f,
                                      pt.orig_level)


def build_local_ba_problem(m: MapState, new_kf_slot: torch.Tensor,
                           core_n_kfs: int = 3,
                           max_core_points: int = 4096):
    """Core selection, point compaction and observation extraction:
    (BAProblem, sel (Pc,), selok (Pc,), variable (K,)).  new_kf_slot is a
    0-d tensor holding a valid slot."""
    kf, pt = m.kf, m.pt
    K = kf.R.shape[0]
    P = pt.pos.shape[0]
    dev = kf.R.device
    kpos = kf_positions(kf)
    here = torch.arange(K, device=dev) == new_kf_slot
    new_pos = kpos.index_select(0, new_kf_slot.reshape(1).to(torch.int64))[0]
    d = torch.linalg.vector_norm(kpos - new_pos, dim=-1)
    d = torch.where(kf.active & ~here, d, torch.full_like(d, float("inf")))
    # argsort order: nearest first, lower slot first among ties
    order = torch.sort(d, stable=True)[1][:core_n_kfs]
    variable = torch.zeros((K,), dtype=torch.bool, device=dev) \
        .index_put((order,), torch.isfinite(d[order]))
    variable = (variable | here) & kf.active
    # gauge anchor: with no fixed active keyframe left, the oldest
    # variable keyframe is fixed
    has_fixed = torch.any(kf.active & ~variable)
    age = torch.where(variable, kf.frame_id,
                      torch.full_like(kf.frame_id, torch.iinfo(torch.int32).max))
    oldest = torch.arange(K, device=dev) == torch.argmin(age)
    variable = variable & ~(oldest & ~has_fixed)

    # points: alive, >= 2 observations on active keyframes, one of them on
    # a variable keyframe
    cam_full = torch.cat([torch.clamp(pt.obs_kf, 0, K - 1),
                          torch.clamp(pt.orig_kf, 0, K - 1)[:, None]],
                         dim=1).to(torch.int64)
    mask_full = torch.cat([pt.obs_valid, (pt.orig_kf >= 0)[:, None]], dim=1) \
        & kf.active[cam_full]
    n_obs = torch.sum(mask_full, dim=1)
    in_core = torch.any(mask_full & variable[cam_full], dim=1)
    p_valid = (pt.ptype != TYPE_DELETED) & (n_obs >= 2) & in_core
    sel, selok = mask_compact_priority(p_valid, min(P, max_core_points),
                                       n_obs)
    obs_cam, obs_f, obs_level, obs_mask = _extract_observations_rows(
        kf, pt.obs_kf[sel], pt.obs_feat[sel], pt.obs_valid[sel],
        torch.where(selok, pt.orig_kf[sel], torch.full_like(sel, -1,
                                                            dtype=torch.int32)),
        pt.orig_f[sel], pt.orig_level[sel])
    obs_mask = obs_mask & selok[:, None]
    prob = BAProblem(kf.R, kf.t, variable, pt.pos[sel], selok, obs_cam,
                     obs_f, obs_level, obs_mask)
    return prob, sel, selok, variable


@graphed.jit(static_argnames=("n_iter", "core_n_kfs", "shard_axis",
                              "max_core_points"))
def run_local_ba(m: MapState, new_kf_slot: torch.Tensor,
                 huber_width_px: float, reproj_thresh_px: float, fx: float,
                 n_iter: int = 10, core_n_kfs: int = 3,
                 max_core_points: int = 4096,
                 shard_axis: str = "", enable=True,
                 inplace: bool = False) -> MapState:
    """Local BA around ``new_kf_slot``; returns the updated map (variable
    keyframe poses, the solved points' positions, pruned observations and
    starved points deleted).  With ``shard_axis`` (mesh mode,
    parallel/fused_mesh.py) the point blocks of the Schur solve are
    sharded over that axis of the ambient mesh: each rank solves its rows,
    the reduced camera system is all-reduced, and the solved rows are
    all-gathered for the write-back.  ``enable`` (a 0-d bool tensor or a
    bool) masks the write-back, which ``inplace`` makes into the point
    pool itself."""
    kf, pt = m.kf, m.pt
    M = pt.obs_kf.shape[1]
    prob, sel, selok, variable = build_local_ba_problem(
        m, new_kf_slot, core_n_kfs, max_core_points)
    if shard_axis:
        pts = ("p_w", "p_valid", "obs_cam", "obs_f", "obs_level",
               "obs_mask")
        prob = prob._replace(**shard_dim0(
            {k: getattr(prob, k) for k in pts}, shard_axis))
    res = solve_ba(prob, n_iter=n_iter, huber_width=huber_width_px / fx,
                   reproj_thresh_unitplane=reproj_thresh_px / fx,
                   n_var_max=core_n_kfs + 1,
                   reduce=functools.partial(psum, axis=shard_axis))
    if shard_axis:
        p_w, inlier = gather_dim0((res.p_w, res.obs_inlier), shard_axis)
        res = res._replace(p_w=p_w, obs_inlier=inlier)
    variable = variable & enable
    kf = kf._replace(R=torch.where(variable[:, None, None], res.R, kf.R),
                     t=torch.where(variable[:, None], res.t, kf.t))
    ov_rows = pt.obs_valid[sel] & res.obs_inlier[:, :M]
    n_obs_after = torch.sum(ov_rows, dim=1) + (pt.orig_kf[sel] >= 0)
    ptype_sel = pt.ptype[sel]
    starved = selok & (n_obs_after < 2) & (ptype_sel >= TYPE_UNKNOWN)
    put = lambda arr, val: set_rows(arr, sel, val, selok & enable,  # noqa: E731
                                    inplace)
    pt = pt._replace(
        pos=put(pt.pos, res.p_w),
        obs_valid=put(pt.obs_valid, ov_rows),
        ptype=put(pt.ptype, torch.where(
            starved, torch.full_like(ptype_sel, TYPE_DELETED), ptype_sel)))
    return m._replace(kf=kf, pt=pt)


@graphed.jit(static_argnames=("n_iter",))
def run_two_view_ba(m: MapState, slot_fixed: torch.Tensor,
                    slot_var: torch.Tensor, huber_width: float,
                    reproj_thresh_px: float, fx: float,
                    n_iter: int = 10) -> MapState:
    """Two-view BA of the bootstrap pair: ``slot_fixed`` stays, the other
    keyframe and every point seen by both move; a point with any outlier
    observation is deleted (safeDeletePoint)."""
    kf, pt = m.kf, m.pt
    K = kf.R.shape[0]
    ar = torch.arange(K, device=kf.R.device)
    variable = (ar == slot_var) & kf.active
    obs_cam, obs_f, obs_level, obs_mask = _extract_observations(m)
    on = lambda s: torch.any(obs_mask & (obs_cam == s), dim=1)  # noqa: E731
    p_valid = (pt.ptype != TYPE_DELETED) & on(slot_fixed) & on(slot_var)
    res = solve_ba(BAProblem(kf.R, kf.t, variable, pt.pos, p_valid, obs_cam,
                             obs_f, obs_level, obs_mask),
                   n_iter=n_iter, huber_width=huber_width / fx,
                   reproj_thresh_unitplane=reproj_thresh_px / fx,
                   n_var_max=8)
    bad = p_valid & torch.any(obs_mask & ~res.obs_inlier, dim=1)
    return m._replace(
        kf=kf._replace(R=torch.where(variable[:, None, None], res.R, kf.R),
                       t=torch.where(variable[:, None], res.t, kf.t)),
        pt=pt._replace(
            pos=torch.where(p_valid[:, None], res.p_w, pt.pos),
            ptype=torch.where(bad, torch.full_like(pt.ptype, TYPE_DELETED),
                              pt.ptype)))


@graphed.jit(static_argnames=("n_iter",))
def run_global_ba(m: MapState, huber_width_px: float, loba_thresh_px: float,
                  poseoptim_thresh_px: float, fx: float,
                  n_iter: int = 10) -> MapState:
    """Global BA: every active keyframe and every point with two or more
    observations move.  Observations whose current reprojection error is
    above the pose optimizer's threshold are left out and removed first;
    after the solve, those above the local-BA threshold are removed too
    (removePtFrameRef)."""
    kf, pt = m.kf, m.pt
    K = kf.R.shape[0]
    M = pt.obs_kf.shape[1]
    obs_cam, obs_f, obs_level, obs_mask = _extract_observations(m)
    cam = torch.clamp(obs_cam, 0, K - 1).to(torch.int64)
    p_c, _ = _apply_cams(kf.R, kf.t, cam, pt.pos)
    err = project2d(obs_f) - project2d(p_c)
    stale = obs_mask & (torch.sum(err * err, dim=-1)
                        > (poseoptim_thresh_px / fx) ** 2)
    obs_mask = obs_mask & ~stale
    p_valid = (pt.ptype != TYPE_DELETED) & (torch.sum(obs_mask, 1) >= 2)
    res = solve_ba(BAProblem(kf.R, kf.t, kf.active, pt.pos, p_valid, obs_cam,
                             obs_f, obs_level, obs_mask),
                   n_iter=n_iter, huber_width=huber_width_px / fx,
                   reproj_thresh_unitplane=loba_thresh_px / fx)
    keep = ~stale[:, :M] & (res.obs_inlier[:, :M] | ~p_valid[:, None])
    var = kf.active
    return m._replace(
        kf=kf._replace(R=torch.where(var[:, None, None], res.R, kf.R),
                       t=torch.where(var[:, None], res.t, kf.t)),
        pt=pt._replace(pos=torch.where(p_valid[:, None], res.p_w, pt.pos),
                       obs_valid=pt.obs_valid & keep))
