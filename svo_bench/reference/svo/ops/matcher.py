"""Patch correspondence: affine warps, direct matching, epipolar search.

Port of ``rpg_svo_tpu/ops/matcher.py`` (Matcher, svo/src/matcher.cpp:
33-321): the affine warp estimate, the best search level, the reference
patch warps (out of a pyramid or a creation-time tile), the ZMSSD score,
the direct alignment of the reprojector, and the depth filter's epipolar
search: one rotated strip of nearest samples along the segment, the ZMSSD
of every 1-px window from shifted slices of it, align2D at the best window
and re-triangulation.

The JAX scan pads its windows to 128 lanes and gathers through flat index
vectors; that is TPU layout.  Here only the ``steps`` windows are formed,
with the same window limits (``min(n_steps, steps)``, windows not fully
inside the level score inf), the same row subsampling and normalisation,
and the first index winning ties.  The two-tier scan keeps the JAX long
table size, ``min(ceil(long_k / 128) * 128, N)``, which decides which long
segments are scanned.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_bench.reference.svo.core import graphed
from svo_bench.reference.svo.core.map import mask_compact, set_rows
from svo_bench.reference.svo.geometry.cameras import project2d
from svo_bench.reference.svo.geometry.linalg import det2x2, inv2x2
from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.geometry.triangulation import depth_from_triangulation
from svo_bench.reference.svo.ops.feature_align import (
    BORDERED, HALFPATCH, PATCH, align1d, align2d, align_features)
from svo_bench.reference.svo.ops.patches import sample_tiles

# static cap on epipolar scan steps (the reference caps at 1000)
DEFAULT_MAX_STEPS = 128
ZMSSD_THRESHOLD = 2000.0 * PATCH * PATCH

FEATURE_CORNER = 0
FEATURE_EDGELET = 1
# epipolar edgelet pre-filter: reject when |grad_cur . epi_dir| is below
# this (epi_search_edgelet_max_angle, matcher.h:90)
EDGELET_MAX_ANGLE_COS = 0.7


def _bmv2(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, 2, 2) x (N, P, 2) -> (N, P, 2)."""
    return torch.sum(M[:, None, :, :] * v[:, :, None, :], dim=-1)


def _safe_z(a: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(a) < 1e-10, torch.full_like(a, 1e-10), a)


def warp_matrix_affine(cam_ref, cam_cur, px_ref, f_ref, depth_ref,
                       T_cur_ref: SE3, level_ref,
                       halfpatch: int = HALFPATCH + 1) -> torch.Tensor:
    """Affine warp A (N, 2, 2) mapping level-0 ref px offsets to level-0
    cur px offsets, estimated at the feature's own pyramid scale."""
    p_ref = f_ref * depth_ref[..., None]
    scale = torch.exp2(level_ref.to(torch.float32))[..., None]
    hp = float(halfpatch)
    zero = torch.zeros_like(depth_ref)
    full = torch.full_like(depth_ref, hp)
    du = px_ref + torch.stack([full, zero], -1) * scale
    dv = px_ref + torch.stack([zero, full], -1) * scale
    f_du = cam_ref.cam2world(du)
    f_dv = cam_ref.cam2world(dv)
    z = p_ref[..., 2:3]
    p_du = f_du / _safe_z(f_du[..., 2:3]) * z
    p_dv = f_dv / _safe_z(f_dv[..., 2:3]) * z
    c0 = cam_cur.world2cam(T_cur_ref.apply(p_ref))
    cu = cam_cur.world2cam(T_cur_ref.apply(p_du))
    cv = cam_cur.world2cam(T_cur_ref.apply(p_dv))
    col0 = (cu - c0) / (hp * scale)
    col1 = (cv - c0) / (hp * scale)
    return torch.stack([col0, col1], dim=-1)


def best_search_level(A_level0, level_ref, max_level: int) -> torch.Tensor:
    """Pyramid level where one ref-level pixel covers < 3 px^2
    (matcher.cpp:57-70); det at the ref level is det(A0) * 4^level_ref."""
    D = torch.abs(det2x2(A_level0)) \
        * torch.pow(4.0, level_ref.to(torch.float32))
    lvl = torch.ceil(torch.log2(torch.clamp(D, min=1e-12) / 3.0) / 2.0)
    return torch.clamp(lvl, 0, max_level).to(torch.int32)


def zmssd(ref_patch, cur_patch, dim: int = -1) -> torch.Tensor:
    """Zero-mean SSD between patches along ``dim`` (vikit patch_score)."""
    r = ref_patch - torch.mean(ref_patch, dim=dim, keepdim=True)
    c = cur_patch - torch.mean(cur_patch, dim=dim, keepdim=True)
    return torch.sum((r - c) ** 2, dim=dim)


def _grid(n: int, half: float, device) -> torch.Tensor:
    r = torch.arange(n, dtype=torch.float32, device=device) - half
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def _affine_coords(A_level0, px_ref, level_ref, search_level):
    """Level-``level_ref`` sample coords (N, 100, 2) of the bordered patch
    laid out on the cur ``search_level`` grid and mapped through A^-1."""
    dev = A_level0.device
    Ainv = inv2x2(A_level0 + 1e-9 * torch.eye(2, device=dev))
    grid = _grid(BORDERED, HALFPATCH + 1, dev)                  # (100, 2)
    scale_cur = torch.exp2(search_level.to(torch.float32))
    scale_ref = torch.exp2(level_ref.to(torch.float32))
    pc = grid[None] * scale_cur[:, None, None]
    po = torch.sum(Ainv[:, None, :, :] * pc[:, :, None, :], dim=-1)
    return (px_ref[:, None, :] + po) / scale_ref[:, None, None]


def _rotated_coords(A_level0, px_ref, level_ref, search_level, dir_lvl):
    """Level-``level_ref`` sample coords (N, 64, 2) of an 8x8 patch in the
    cur frame's (epipolar dir, normal) basis; flat index u * 8 + v, u along
    the line (the order of the scan windows)."""
    dev = A_level0.device
    Ainv = inv2x2(A_level0 + 1e-9 * torch.eye(2, device=dev))
    r = torch.arange(PATCH, dtype=torch.float32, device=dev) - HALFPATCH
    uu, vv = torch.meshgrid(r, r, indexing="ij")
    nrm = torch.stack([-dir_lvl[:, 1], dir_lvl[:, 0]], dim=-1)
    offs = (uu.reshape(-1)[None, :, None] * dir_lvl[:, None, :]
            + vv.reshape(-1)[None, :, None] * nrm[:, None, :])
    scale_cur = torch.exp2(search_level.to(torch.float32))
    scale_ref = torch.exp2(level_ref.to(torch.float32))
    po = _bmv2(Ainv, offs * scale_cur[:, None, None])
    return (px_ref[:, None, :] + po) / scale_ref[:, None, None]


def warp_affine_patches(A_level0, ref_pyr, px_ref, level_ref, search_level):
    """Inverse-warp 10x10 bordered ref patches (N, 100) out of a
    FlatPyramid at each feature's own level; valid (N,)."""
    coords = _affine_coords(A_level0, px_ref, level_ref, search_level)
    vals, ok = ref_pyr.bilinear(level_ref[:, None], coords)
    return vals, torch.all(ok, dim=-1)


def warp_patches_rotated(A_level0, ref_pyr, px_ref, level_ref, search_level,
                         dir_lvl):
    """Rotated 8x8 ref patches (N, 64) out of a FlatPyramid; valid (N,)."""
    coords = _rotated_coords(A_level0, px_ref, level_ref, search_level,
                             dir_lvl)
    vals, ok = ref_pyr.bilinear(level_ref[:, None], coords)
    return vals, torch.all(ok, dim=-1)


def warp_affine_patches_tiles(A_level0, tiles, xy0, px_ref, level_ref,
                              search_level):
    """Inverse-warp 10x10 bordered ref patches (N, 100) out of the
    creation-time tiles; valid (N,) when every sample is inside."""
    coords = _affine_coords(A_level0, px_ref, level_ref, search_level)
    vals, ok = sample_tiles(tiles, xy0, coords)
    return vals, torch.all(ok, dim=-1)


def warp_rotated_tiles(A_level0, tiles, xy0, px_ref, level_ref,
                       search_level, dir_lvl):
    """8x8 patches along a rotated (dir, normal) frame out of the tiles."""
    coords = _rotated_coords(A_level0, px_ref, level_ref, search_level,
                             dir_lvl)
    vals, ok = sample_tiles(tiles, xy0, coords)
    return vals, torch.all(ok, dim=-1)


class EpipolarMatch(NamedTuple):
    px_cur: torch.Tensor      # (N, 2) level-0 coords of the match
    depth_ref: torch.Tensor   # (N,) triangulated depth along f_ref
    level_cur: torch.Tensor   # (N,) search level used
    success: torch.Tensor     # (N,) bool
    # False only for long segments beyond the two-tier long budget: they
    # were not scanned and get no failure evidence
    scanned: torch.Tensor     # (N,) bool


class EpipolarGeom(NamedTuple):
    """Search geometry shared by the ref-patch samplers and the scan."""
    A: torch.Tensor             # (N, 2, 2) level0->level0 affine warp
    search_level: torch.Tensor  # (N,) int32
    scale: torch.Tensor         # (N,) 2^search_level
    pxA: torch.Tensor           # (N, 2) near endpoint, search-level coords
    dir_lvl: torch.Tensor       # (N, 2) unit epipolar dir, search-level px
    n_steps: torch.Tensor       # (N,) int32 scan steps at 1 px spacing


def epipolar_geometry(cam, T_cur_ref: SE3, px_ref, f_ref, level_ref,
                      d_estimate, d_min, d_max,
                      max_steps: int = DEFAULT_MAX_STEPS,
                      max_level: int = 4) -> EpipolarGeom:
    """Warp matrix, search level and the epipolar segment at that level
    (matcher.cpp:179-260); the level is bumped until the segment fits
    ``max_steps`` 1-px steps."""
    uvA = project2d(T_cur_ref.apply(f_ref * d_min[:, None]))
    uvB = project2d(T_cur_ref.apply(f_ref * d_max[:, None]))
    A = warp_matrix_affine(cam, cam, px_ref, f_ref, d_estimate, T_cur_ref,
                           level_ref)
    search_level = best_search_level(A, level_ref, max_level)
    pxA0 = cam.project_unitplane(uvA)
    pxB0 = cam.project_unitplane(uvB)
    seg0 = torch.linalg.vector_norm(pxB0 - pxA0, dim=-1)
    need = torch.ceil(torch.log2(torch.clamp(
        seg0 / torch.exp2(search_level.to(torch.float32))
        / (max_steps - 1.0), min=1.0)))
    # need >= 0; capping it at max_level before the int conversion keeps
    # the sum in range and leaves the clipped level unchanged
    search_level = torch.clamp(
        search_level + torch.clamp(need, max=max_level).to(torch.int32),
        0, max_level)
    scale = torch.exp2(search_level.to(torch.float32))
    pxA = pxA0 / scale[:, None]
    pxB = pxB0 / scale[:, None]
    seg = pxB - pxA
    seg_len = torch.linalg.vector_norm(seg, dim=-1)
    dir_lvl = seg / torch.clamp(seg_len, min=1e-9)[:, None]
    degen = seg_len < 1e-6
    unit_x = torch.stack([torch.ones_like(seg_len),
                          torch.zeros_like(seg_len)], dim=-1)
    dir_lvl = torch.where(degen[:, None], unit_x, dir_lvl)
    # the int conversion saturates in JAX; clamp first (NaN counts as 0)
    n_steps = torch.clamp(torch.clamp(torch.nan_to_num(seg_len, nan=0.0),
                                      max=float(max_steps))
                          .to(torch.int32) + 1, 1, max_steps)
    return EpipolarGeom(A, search_level, scale, pxA, dir_lvl, n_steps)


def _strip_scan(cur_pyr, pxA, dir_lvl, search_level, n_steps, ref_rot,
                steps: int, scan_rows: int = PATCH):
    """ZMSSD of the ``steps`` 1-px windows along the epipolar line.

    One rotated strip of scan_rows x (steps + 8) nearest samples is read
    along the line; each window's ZMSSD is
    sum(w^2) - (sum w)^2 / n - 2 sum(w r') + sum(r'^2) (r' the zero-mean
    ref patch over the same scan_rows rows), summed over 8 shifted slices
    of the strip.  Returns (best score (N,), best step (N,) int32): inf
    where no window in [0, min(n_steps, steps)) lies fully inside the
    level; the first index wins ties."""
    assert PATCH % scan_rows == 0
    dev = pxA.device
    row_sel = torch.arange(0, PATCH, PATCH // scan_rows, device=dev)
    nrm = torch.stack([-dir_lvl[:, 1], dir_lvl[:, 0]], dim=-1)
    cs = torch.arange(steps + PATCH, dtype=torch.float32, device=dev) \
        - HALFPATCH
    rs = (torch.arange(PATCH, dtype=torch.float32, device=dev)
          - HALFPATCH)[row_sel]
    coords = (pxA[:, None, None, :]
              + rs[None, :, None, None] * nrm[:, None, None, :]
              + cs[None, None, :, None] * dir_lvl[:, None, None, :])
    strip, strip_ok = cur_pyr.nearest(search_level[:, None, None], coords)
    okf = strip_ok.to(strip.dtype)
    r2 = ref_rot.reshape(-1, PATCH, PATCH)[:, :, row_sel]
    r2 = r2 - torch.mean(r2, dim=(1, 2))[:, None, None]     # (N, 8u, rows)
    swin = s2win = cross = nok = None
    for u in range(PATCH):
        sl = strip[:, :, u: u + steps]
        terms = (torch.sum(sl, dim=1), torch.sum(sl * sl, dim=1),
                 torch.sum(sl * r2[:, u, :, None], dim=1),
                 torch.sum(okf[:, :, u: u + steps], dim=1))
        if swin is None:
            swin, s2win, cross, nok = terms
        else:
            swin, s2win, cross, nok = (swin + terms[0], s2win + terms[1],
                                       cross + terms[2], nok + terms[3])
    rss = torch.sum(r2 * r2, dim=(1, 2))
    sc = s2win - swin * swin * (1.0 / (PATCH * scan_rows)) \
        - 2.0 * cross + rss[:, None]
    wok = nok >= float(PATCH * scan_rows) - 0.5
    step_ids = torch.arange(steps, dtype=torch.int32, device=dev)[None, :]
    lim = torch.clamp(n_steps, max=steps)
    sc = torch.where((step_ids < lim[:, None]) & wok, sc,
                     torch.full_like(sc, float("inf")))
    return torch.amin(sc, dim=1), torch.argmin(sc, dim=1).to(torch.int32)


def long_table_rows(long: torch.Tensor, long_k: int):
    """(the long segments the table may hold, its row count): all of
    them, in a table of ``min(ceil(long_k / 128) * 128, N)`` rows."""
    N = long.shape[0]
    return long, min(-(-(long_k or N) // 128) * 128, N)


def epipolar_search(cur_pad, cam, geom: EpipolarGeom, T_cur_ref: SE3, f_ref,
                    ref_patch_border, ref_rot, ref_ok, valid,
                    max_steps: int = DEFAULT_MAX_STEPS, n_iter: int = 10,
                    ftr_type=None, ftr_grad=None, align_1d: bool = False,
                    short_steps: int = 0, long_k: int = 0,
                    scan_rows: int = PATCH,
                    pick_long=long_table_rows) -> EpipolarMatch:
    """ZMSSD scan along the epipolar segment of the padded current pyramid,
    align2D at the best window (align1D along the epipolar direction with
    ``align_1d``, matcher.h options_.align_1d), and triangulation
    (findEpipolarMatchDirect, matcher.cpp:179-321).

    Two-tier scan (``short_steps``): segments of at most short_steps
    windows scan a short strip in place; longer ones are compacted into a
    table of ``min(ceil(long_k / 128) * 128, N)`` rows and scan at
    max_steps; longs beyond it are not scanned (``scanned`` False).
    ``pick_long(long, long_k)`` gives the long rows the table may hold and
    its row count (``long_table_rows``; a mesh step whose rows are one
    rank's of a sharded domain picks them over the whole domain)."""
    cur_pyr = cur_pad.flat_view()
    pxA, dir_lvl = geom.pxA, geom.dir_lvl
    search_level, n_steps = geom.search_level, geom.n_steps
    N = pxA.shape[0]
    inf = float("inf")
    if short_steps and short_steps < max_steps:
        is_short = n_steps <= short_steps
        sc_s, bi_s = _strip_scan(cur_pyr, pxA, dir_lvl, search_level,
                                 n_steps, ref_rot, short_steps, scan_rows)
        long, kl = pick_long(~is_short & valid & ref_ok, long_k)
        sel, okl = mask_compact(long, kl)
        sc_lc, bi_lc = _strip_scan(
            cur_pyr, pxA[sel], dir_lvl[sel], search_level[sel],
            torch.where(okl, n_steps[sel], torch.zeros_like(n_steps[sel])),
            ref_rot[sel], max_steps, scan_rows)
        sc_l = set_rows(torch.full((N,), inf, device=pxA.device), sel,
                        sc_lc, okl)
        bi_l = set_rows(torch.zeros_like(n_steps), sel, bi_lc, okl)
        long_done = set_rows(torch.zeros_like(valid), sel, okl, okl)
        best_score = torch.where(is_short, sc_s, sc_l)
        bi = torch.where(is_short, bi_s, bi_l)
        scanned = is_short | long_done
    else:
        best_score, bi = _strip_scan(cur_pyr, pxA, dir_lvl, search_level,
                                     n_steps, ref_rot, max_steps, scan_rows)
        scanned = torch.ones_like(valid)
    best_px = pxA + bi[:, None].to(torch.float32) * dir_lvl
    found = torch.isfinite(best_score) & valid & ref_ok \
        & (best_score < 2000.0 * PATCH * scan_rows)
    if ftr_type is not None:
        # edgelet pre-filter (matcher.cpp:204-211)
        grad_cur = torch.sum(geom.A * ftr_grad[:, None, :], dim=-1)
        grad_cur = grad_cur / torch.clamp(torch.linalg.vector_norm(
            grad_cur, dim=-1, keepdim=True), min=1e-12)
        cosangle = torch.abs(torch.sum(grad_cur * dir_lvl, dim=-1))
        found = found & ~((ftr_type == FEATURE_EDGELET)
                          & (cosangle < EDGELET_MAX_ANGLE_COS))
    if align_1d:
        px_ref_out, conv = align1d(cur_pad, ref_patch_border, best_px,
                                   dir_lvl, found, n_iter, level=search_level)
    else:
        px_ref_out, conv = align2d(cur_pad, ref_patch_border, best_px, found,
                                   n_iter, level=search_level)
    px_ref_out = torch.where(conv[:, None], px_ref_out, best_px)
    px0 = px_ref_out * geom.scale[:, None]
    f_cur = cam.cam2world(px0)
    d_ref, _, tri_ok = depth_from_triangulation(T_cur_ref, f_ref, f_cur)
    success = conv & found & tri_ok & (d_ref > 0)
    return EpipolarMatch(px0, d_ref, search_level, success, scanned)


@graphed.jit(static_argnames=("max_steps", "n_iter", "max_level",
                                 "align_1d", "short_steps", "long_k",
                                 "scan_rows"))
def epipolar_match(cur_pad, ref_pad, cam, T_cur_ref: SE3, px_ref, f_ref,
                   level_ref, d_estimate, d_min, d_max, valid,
                   max_steps: int = DEFAULT_MAX_STEPS, n_iter: int = 10,
                   max_level: int = 4, ftr_type=None, ftr_grad=None,
                   align_1d: bool = False, short_steps: int = 0,
                   long_k: int = 0, scan_rows: int = PATCH) -> EpipolarMatch:
    """Batched epipolar search with the ref patches warped out of the
    reference frame's padded pyramid (the fused step warps them out of the
    seeds' creation-time tiles and calls epipolar_geometry and
    epipolar_search itself)."""
    geom = epipolar_geometry(cam, T_cur_ref, px_ref, f_ref, level_ref,
                             d_estimate, d_min, d_max, max_steps, max_level)
    ref_pyr = ref_pad.flat_view()
    border, ok_b = warp_affine_patches(geom.A, ref_pyr, px_ref, level_ref,
                                       geom.search_level)
    rot, ok_r = warp_patches_rotated(geom.A, ref_pyr, px_ref, level_ref,
                                     geom.search_level, geom.dir_lvl)
    return epipolar_search(cur_pad, cam, geom, T_cur_ref, f_ref, border, rot,
                           ok_b & ok_r, valid, max_steps=max_steps,
                           n_iter=n_iter, ftr_type=ftr_type,
                           ftr_grad=ftr_grad, align_1d=align_1d,
                           short_steps=short_steps, long_k=long_k,
                           scan_rows=scan_rows)


class DirectMatch(NamedTuple):
    px_cur: torch.Tensor      # (N, 2) refined level-0 coords
    level_cur: torch.Tensor   # (N,)
    success: torch.Tensor     # (N,)
    grad_cur: torch.Tensor    # (N, 2) warped unit gradient dir


@graphed.jit(static_argnames=("n_iter", "max_level"))
def find_match_direct(cur_pyr, ref_pyr, cam, T_cur_ref: SE3, px_ref, f_ref,
                      level_ref, depth_ref, px_cur_init, valid,
                      n_iter: int = 10, max_level: int = 4, ftr_type=None,
                      ftr_grad=None) -> DirectMatch:
    """Matcher::findMatchDirect (matcher.cpp:135-177): warp the reference
    observation's patch out of ref_pyr (a FlatPyramid or BoundPyramidPool)
    and align it at the projected location in cur_pyr (any source
    ``align_features`` takes).  Edgelets refine 1-D along the warped
    gradient direction (matcher.cpp:161-167), corners 2-D."""
    A = warp_matrix_affine(cam, cam, px_ref, f_ref, depth_ref, T_cur_ref,
                           level_ref)
    search_level = best_search_level(A, level_ref, max_level)
    patch_border, ref_ok = warp_affine_patches(A, ref_pyr, px_ref, level_ref,
                                               search_level)
    return _direct_align(cur_pyr, A, search_level, patch_border, ref_ok,
                         px_cur_init, valid, n_iter, ftr_type, ftr_grad)


def find_match_direct_tiles(cur_pad, ref_tiles, ref_xy0, cam,
                            T_cur_ref: SE3, px_ref, f_ref, level_ref,
                            depth_ref, px_cur_init, valid, n_iter: int = 10,
                            max_level: int = 4, ftr_type=None,
                            ftr_grad=None) -> DirectMatch:
    """Matcher::findMatchDirect with the reference patch warped out of its
    creation-time tile and aligned at the projected location."""
    A = warp_matrix_affine(cam, cam, px_ref, f_ref, depth_ref, T_cur_ref,
                           level_ref)
    search_level = best_search_level(A, level_ref, max_level)
    patch_border, ref_ok = warp_affine_patches_tiles(
        A, ref_tiles, ref_xy0, px_ref, level_ref, search_level)
    return _direct_align(cur_pad, A, search_level, patch_border, ref_ok,
                         px_cur_init, valid, n_iter, ftr_type, ftr_grad)


def _direct_align(cur_pad, A, search_level, patch_border, ref_ok,
                  px_cur_init, valid, n_iter, ftr_type,
                  ftr_grad) -> DirectMatch:
    N = px_cur_init.shape[0]
    dev = px_cur_init.device
    scale = torch.exp2(search_level.to(torch.float32))
    px_lvl = px_cur_init / scale[:, None]
    if ftr_type is None:
        is_edge = torch.zeros((N,), dtype=torch.bool, device=dev)
        grad = torch.zeros((N, 2), device=dev)
        grad[:, 0] = 1.0
    else:
        is_edge = ftr_type == FEATURE_EDGELET
        grad = ftr_grad
    dir_cur = torch.sum(A * grad[:, None, :], dim=-1)
    dir_cur = dir_cur / torch.clamp(
        torch.linalg.vector_norm(dir_cur, dim=-1, keepdim=True), min=1e-12)
    px2, conv = align_features(cur_pad, patch_border, px_lvl,
                               valid & ref_ok, n_iter, level=search_level,
                               direction=dir_cur, is_1d=is_edge)
    out_px = torch.where(conv[:, None], px2, px_lvl)
    return DirectMatch(out_px * scale[:, None], search_level, conv, dir_cur)
