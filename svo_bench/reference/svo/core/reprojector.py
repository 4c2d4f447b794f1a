"""Map reprojection: project the points, pick one per cell, match.

Port of ``rpg_svo_tpu/core/reprojector.py`` (Reprojector,
svo/src/reprojector.cpp:40-220): every live point projects into the frame;
candidates that miss cost n_fail += 3 (deleted above 30); each grid cell
picks its best point (GOOD > UNKNOWN > CANDIDATE); the attempt budget
keeps the best cells by quality tier, ties broken by a fixed shuffled cell
order; the chosen points align against their closest-view reference
observation (warped out of its creation-time tile); counters and
promotions go back to the pool; the first ``max_fts`` successes form the
frame's feature table.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from svo_bench.reference.svo.core import graphed
from svo_bench.reference.svo.core.map import (
    TYPE_CANDIDATE, TYPE_DELETED, TYPE_GOOD, TYPE_UNKNOWN, MapState,
    kf_positions, mask_compact)
from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.ops.matcher import find_match_direct_tiles


class ReprojectResult(NamedTuple):
    feat_px: torch.Tensor       # (F, 2) matched level-0 px
    feat_level: torch.Tensor    # (F,) int32
    feat_point: torch.Tensor    # (F,) int32 point id, -1 none
    feat_valid: torch.Tensor    # (F,) bool
    feat_type: torch.Tensor     # (F,) int32
    feat_grad: torch.Tensor     # (F, 2)
    n_matches: torch.Tensor     # int32
    n_trials: torch.Tensor      # int32


def attempt_budget(C: int, max_fts: int, factor: float = 2.0) -> int:
    """Static attempt count: the best max(factor * max_fts, 256) cells,
    rounded up to 8 (the reference attempts until max_fts matches)."""
    if max_fts and max_fts < C:
        return min(C, -(-max(int(factor * max_fts), 256) // 8) * 8)
    return C


# unbounded, as ops/tiles._level_table: a captured CUDA graph reads it
@functools.cache
def _cell_perm(C: int, device: str) -> torch.Tensor:
    """The fixed shuffled cell order (numpy seed 0, as the JAX package),
    made once per device."""
    perm = np.random.default_rng(0).permutation(C).astype(np.int64)
    return torch.from_numpy(perm).to(device)


@graphed.jit
def project_points(pt, T_cur: SE3, cam):
    p_cur = T_cur.apply(pt.pos)
    px = cam.world2cam(p_cur)
    vis0 = pt.active & (p_cur[..., 2] > 0.0) \
        & cam.is_in_frame(px, boundary=8.0)
    return px, vis0


@graphed.jit
def candidate_bookkeeping(pt, vis0):
    cand_miss = pt.active & (pt.ptype == TYPE_CANDIDATE) & ~vis0
    n_fail = pt.n_fail + torch.where(cand_miss, 3, 0).to(torch.int32)
    ptype = torch.where((pt.ptype == TYPE_CANDIDATE) & (n_fail > 30),
                        torch.full_like(pt.ptype, TYPE_DELETED), pt.ptype)
    return n_fail, ptype, vis0 & (ptype != TYPE_DELETED)


@graphed.jit(static_argnames=("grid_size", "ncx", "ncy", "max_fts",
                              "attempt_factor"))
def grid_select(px, visible, ptype, grid_size: int, ncx: int, ncy: int,
                max_fts: int, attempt_factor: float = 2.0):
    """Per-cell best point by quality, then the attempt budget.  Returns
    (has (A,), sel_pt (A,) int64)."""
    P = px.shape[0]
    C = ncx * ncy
    dev = px.device
    cx = torch.clamp(torch.div(px[:, 0], grid_size, rounding_mode="floor")
                     .to(torch.int64), 0, ncx - 1)
    cy = torch.clamp(torch.div(px[:, 1], grid_size, rounding_mode="floor")
                     .to(torch.int64), 0, ncy - 1)
    cell = cy * ncx + cx
    ar = torch.arange(P, device=dev)
    comp = torch.where(visible, ptype.to(torch.int64) * P + ar,
                       torch.full_like(ar, -1))
    # segment max; empty cells hold the int minimum, as jax.ops.segment_max
    best = torch.full((C,), torch.iinfo(torch.int64).min, device=dev) \
        .scatter_reduce(0, cell, comp, reduce="amax", include_self=True)
    has = best >= 0
    sel_pt = torch.where(has, best % P, torch.zeros_like(best))
    A = attempt_budget(C, max_fts, attempt_factor)
    if A < C:
        tier = torch.clamp(torch.div(best, P, rounding_mode="floor"), 0, 3)
        key = torch.where(has, tier * C + _cell_perm(C, str(dev)),
                          torch.full_like(best, -1))
        # lax.top_k order: descending, lower index first among ties
        cell_sel = torch.sort(key, descending=True, stable=True)[1][:A]
        has = has[cell_sel]
        sel_pt = sel_pt[cell_sel]
    return has, sel_pt


@graphed.jit(static_argnames=("max_level", "max_fts"))
def match_cells(m: MapState, T_cur: SE3, cam, n_fail, ptype, has, sel_pt,
                max_level: int, cur_pad, max_fts: int, inplace: bool = False):
    """Closest-view reference observation, batched direct matching and the
    counter updates (into the point pool itself with ``inplace``).
    Returns (PointStore, ReprojectResult)."""
    pt = m.pt
    K = m.kf.R.shape[0]
    sel_pos = pt.pos[sel_pt]
    cam_pos_w = T_cur.inverse().t
    unit = lambda d: d / torch.clamp(torch.linalg.vector_norm(  # noqa: E731
        d, dim=-1, keepdim=True), min=1e-12)
    dir_cur = unit(sel_pos - cam_pos_w)
    obs_kf = pt.obs_kf[sel_pt]
    obs_feat = pt.obs_feat[sel_pt]
    obs_ok = pt.obs_valid[sel_pt]
    kf_pos = kf_positions(m.kf)
    obs_kf_safe = torch.clamp(obs_kf, 0, K - 1).to(torch.int64)
    dir_obs = unit(sel_pos[:, None, :] - kf_pos[obs_kf_safe])
    ninf = float("-inf")
    cosang = torch.sum(dir_obs * dir_cur[:, None, :], dim=-1)
    cosang = torch.where(obs_ok, cosang, torch.full_like(cosang, ninf))
    orig_kf = pt.orig_kf[sel_pt]
    okf_safe = torch.clamp(orig_kf, 0, K - 1).to(torch.int64)
    dir_orig = unit(sel_pos - kf_pos[okf_safe])
    cos_orig = torch.sum(dir_orig * dir_cur, -1)
    cos_orig = torch.where(orig_kf >= 0, cos_orig,
                           torch.full_like(cos_orig, ninf))
    all_cos = torch.cat([cosang, cos_orig[:, None]], dim=1)
    best_obs = torch.argmax(all_cos, dim=1)
    best_cos = torch.amax(all_cos, dim=1)
    M = obs_kf.shape[1]
    use_orig = best_obs == M
    bo = torch.clamp(best_obs, 0, M - 1)[:, None]
    ref_kf = torch.where(use_orig, orig_kf,
                         torch.gather(obs_kf, 1, bo)[:, 0])
    ref_feat = torch.gather(obs_feat, 1, bo)[:, 0]
    kf_safe = torch.clamp(ref_kf, 0, K - 1).to(torch.int64)
    ft_safe = torch.clamp(ref_feat, 0, m.kf.feat_px.shape[1] - 1) \
        .to(torch.int64)
    uo1 = use_orig[:, None]
    ref_px = torch.where(uo1, pt.orig_px[sel_pt],
                         m.kf.feat_px[kf_safe, ft_safe])
    ref_f = torch.where(uo1, pt.orig_f[sel_pt],
                        m.kf.feat_f[kf_safe, ft_safe])
    ref_level = torch.where(use_orig, pt.orig_level[sel_pt],
                            m.kf.feat_level[kf_safe, ft_safe])
    ref_type = torch.where(use_orig, pt.orig_type[sel_pt],
                           m.kf.feat_type[kf_safe, ft_safe])
    ref_grad = torch.where(uo1, pt.orig_grad[sel_pt],
                           m.kf.feat_grad[kf_safe, ft_safe])
    ref_tile = torch.where(uo1, pt.orig_tile[sel_pt],
                           m.kf.feat_tile[kf_safe, ft_safe])
    ref_xy0 = torch.where(uo1, pt.orig_tile_xy0[sel_pt],
                          m.kf.feat_tile_xy0[kf_safe, ft_safe])
    # 60 deg cutoff (point.cpp:97-117)
    attempt = has & (best_cos > 0.5) & (ref_kf >= 0)

    T_kf_w = SE3(m.kf.R[kf_safe], m.kf.t[kf_safe])
    T_cur_ref = T_cur * T_kf_w.inverse()
    p_ref = T_kf_w.apply(sel_pos)
    depth_ref = torch.linalg.vector_norm(p_ref, dim=-1)
    px_init = cam.world2cam(T_cur.apply(sel_pos))
    match = find_match_direct_tiles(
        cur_pad, ref_tile, ref_xy0, cam, T_cur_ref, ref_px, ref_f,
        ref_level, depth_ref, px_init, attempt, max_level=max_level,
        ftr_type=ref_type, ftr_grad=ref_grad)
    success = attempt & match.success \
        & cam.is_in_frame(match.px_cur, boundary=2.0)

    def count(arr, hit):
        ones = hit.to(torch.int32)
        if inplace:
            return arr.index_add_(0, sel_pt, ones)
        return arr.index_add(0, sel_pt, ones)

    n_succ = count(pt.n_succ, success)
    n_fail = count(n_fail, attempt & ~success)
    full = lambda v: torch.full_like(ptype, v)  # noqa: E731
    ptype = torch.where((ptype == TYPE_UNKNOWN) & (n_fail > 15),
                        full(TYPE_DELETED), ptype)
    ptype = torch.where((ptype == TYPE_CANDIDATE) & (n_fail > 30),
                        full(TYPE_DELETED), ptype)
    ptype = torch.where((ptype == TYPE_UNKNOWN) & (n_succ > 10),
                        full(TYPE_GOOD), ptype)
    success = success & (ptype[sel_pt] != TYPE_DELETED)
    pt = pt._replace(n_succ=n_succ, n_fail=n_fail, ptype=ptype)
    A = has.shape[0]
    n_trials = torch.sum(attempt).to(torch.int32)
    if max_fts and max_fts < A:
        # the first max_fts successes, in attempt order (quality tier,
        # then the shuffled cells: the reference stops at max_fts matches)
        fsel, fok = mask_compact(success, max_fts)
        return pt, ReprojectResult(
            feat_px=match.px_cur[fsel],
            feat_level=match.level_cur[fsel],
            feat_point=torch.where(fok, sel_pt[fsel],
                                   torch.full_like(fsel, -1)).to(torch.int32),
            feat_valid=fok,
            feat_type=ref_type[fsel],
            feat_grad=match.grad_cur[fsel],
            n_matches=torch.sum(fok).to(torch.int32),
            n_trials=n_trials)
    return pt, ReprojectResult(
        feat_px=match.px_cur, feat_level=match.level_cur,
        feat_point=torch.where(success, sel_pt,
                               torch.full_like(sel_pt, -1)).to(torch.int32),
        feat_valid=success, feat_type=ref_type, feat_grad=match.grad_cur,
        n_matches=torch.sum(success).to(torch.int32), n_trials=n_trials)


@graphed.jit(static_argnames=("grid_size", "ncx", "ncy", "max_level",
                              "max_fts", "attempt_factor"))
def reproject_map(m: MapState, T_cur: SE3, cam, grid_size: int, ncx: int,
                  ncy: int, max_level: int = 4, cur_pad=None,
                  max_fts: int = 0, attempt_factor: float = 2.0,
                  inplace: bool = False):
    """Returns (PointStore with updated counters and types,
    ReprojectResult); ``inplace`` adds the match counters into the pool
    itself."""
    px, vis0 = project_points(m.pt, T_cur, cam)
    n_fail, ptype, visible = candidate_bookkeeping(m.pt, vis0)
    has, sel_pt = grid_select(px, visible, ptype, grid_size, ncx, ncy,
                              max_fts, attempt_factor)
    return match_cells(m, T_cur, cam, n_fail, ptype, has, sel_pt,
                       max_level, cur_pad, max_fts, inplace)
