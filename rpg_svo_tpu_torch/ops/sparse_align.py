"""Sparse model-based image alignment (the tracking hot path).

Port of ``rpg_svo_tpu/ops/sparse_align.py`` (SparseImgAlign,
svo/src/sparse_img_align.cpp:43-258): coarse-to-fine inverse-compositional
Gauss-Newton on 4x4-patch photometric residuals of all tracked features.

On CUDA tensors with a pinhole camera and no robust weights the whole
alignment is one launch of kernel K2 (``align_kernel``).  Everything else
runs ``sparse_img_align_plain``: per level, ``_precompute_level`` cuts each
reference patch with its border from an 8x8 tile of the reference pyramid
and builds the fixed inverse-compositional Jacobians, and ``_level_gn``
runs the Gauss-Newton loop on 17x17 tiles of the current pyramid.

``sparse_img_align_raw`` is the JAX package's path for pyramids given as
level images without a padded stack (``cur_pad=None`` there; the host
pipeline's relocalization takes it): the bordered reference patches are
bilinear samples with per-pixel validity, the current tiles are gathered
with per-pixel validity (not clamped into the level), and a window is
usable only when all of its bilinear support is backed.  JAX runs no kernel
on that path either, so it is plain torch on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rpg_svo_tpu_torch.geometry.linalg import solve6x6_spd
from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.geometry.triangulation import jacobian_xyz2uv
from rpg_svo_tpu_torch.ops import align_kernel
from rpg_svo_tpu_torch.ops.align_kernel import (
    PATCH_HALFSIZE, PATCH_SIZE, SLACK, TILE)
from rpg_svo_tpu_torch.ops.interp import bilinear, patch_grid
from rpg_svo_tpu_torch.ops.tiles import MAX_LEVELS, gather_tiles

PATCH_AREA = PATCH_SIZE * PATCH_SIZE


class AlignResult(NamedTuple):
    T_cur_ref: SE3
    n_tracked: torch.Tensor   # int32: tracked features (measurements / 16)
    H: torch.Tensor           # (6, 6) final-level GN Hessian
    chi2: torch.Tensor        # final mean squared residual
    iters: torch.Tensor       # (MAX_LEVELS,) int32: GN iterations per level


def _window(tile: torch.Tensor, o: torch.Tensor,
            okf: torch.Tensor | None = None):
    """Bilinear 4x4 window at float tile offset o (N, 2) from
    (N, TILE, TILE) tiles: (vals (N, 16), usable (N,)).  Interpolates along
    y, then x, the order of the reference's selection contractions.  Tiles
    with per-pixel validity ``okf`` (N, TILE, TILE) need all of the
    window's 5x5 support backed; without it they are fully backed."""
    N = tile.shape[0]
    oi = torch.floor(o)
    w = o - oi
    oi = oi.to(torch.int64)
    usable = (oi[:, 0] >= 0) & (oi[:, 1] >= 0) \
        & (oi[:, 0] <= TILE - PATCH_SIZE - 1) \
        & (oi[:, 1] <= TILE - PATCH_SIZE - 1)
    ox = torch.clamp(oi[:, 0], 0, TILE - PATCH_SIZE - 1)
    oy = torch.clamp(oi[:, 1], 0, TILE - PATCH_SIZE - 1)
    r = torch.arange(PATCH_SIZE + 1, device=tile.device)
    idx = ((oy[:, None, None] + r[None, :, None]) * TILE
           + ox[:, None, None] + r[None, None, :]).reshape(N, -1)
    reg = torch.gather(tile.reshape(N, -1), 1, idx) \
        .reshape(N, PATCH_SIZE + 1, PATCH_SIZE + 1)
    if okf is not None:
        usable = usable & torch.all(
            torch.gather(okf.reshape(N, -1), 1, idx), dim=1)
    wx = w[:, 0, None, None]
    wy = w[:, 1, None, None]
    rows = (1.0 - wy) * reg[:, :-1, :] + wy * reg[:, 1:, :]
    cur = (1.0 - wx) * rows[:, :, :-1] + wx * rows[:, :, 1:]
    return cur.reshape(N, PATCH_AREA), usable


def _precompute_level(cam_fx: float, feats_px, feats_f, feats_depth,
                      feats_valid, level: int, ref_pad, gather=gather_tiles):
    """Reference patches, fixed IC Jacobians and validity at one level:
    (ref_patch (N, 16), jac (N, 16, 6), valid (N,)).

    The bordered 6x6 patch is one 8x8 tile per feature (cut by ``gather``,
    a ``gather_tiles`` signature) plus a 4-tap blend with the feature's
    shared fractional offset; a clamped tile origin means the bordered
    patch leaves the level, so the feature is invalid.
    """
    scale = 1.0 / (2.0 ** level)
    uv = feats_px * scale
    B = PATCH_SIZE + 2
    fx0 = torch.floor(uv).to(torch.int32)
    want = fx0 - (PATCH_HALFSIZE + 1)
    lv = torch.full((uv.shape[0],), level, dtype=torch.int32,
                    device=uv.device)
    t, x0c, y0c = gather(ref_pad, lv, want[:, 0], want[:, 1], B + 2, B + 2)
    okb = (x0c == want[:, 0]) & (y0c == want[:, 1])
    frac = uv - fx0.to(torch.float32)
    wx = frac[:, 0][:, None, None]
    wy = frac[:, 1][:, None, None]
    v = ((1 - wy) * (1 - wx) * t[:, 0: B + 1, 0: B + 1]
         + (1 - wy) * wx * t[:, 0: B + 1, 1: B + 2]
         + wy * (1 - wx) * t[:, 1: B + 2, 0: B + 1]
         + wy * wx * t[:, 1: B + 2, 1: B + 2])
    pb = v[:, :B, :B]
    vals = pb[:, 1:-1, 1:-1].reshape(-1, PATCH_AREA)
    dx = (0.5 * (pb[:, 1:-1, 2:] - pb[:, 1:-1, :-2])).reshape(-1, PATCH_AREA)
    dy = (0.5 * (pb[:, 2:, 1:-1] - pb[:, :-2, 1:-1])).reshape(-1, PATCH_AREA)
    valid = feats_valid & (feats_depth > 1e-6) & okb
    p_ref = feats_f * feats_depth[:, None]
    fjac = jacobian_xyz2uv(p_ref)
    jac = (dx[..., None] * fjac[:, None, 0, :]
           + dy[..., None] * fjac[:, None, 1, :]) * (cam_fx * scale)
    return vals, jac, valid


def _gn_loop(tile, base, p_ref, ref_patch, jac, valid, T_init: SE3, cam,
             scale: float, n_iter: int, eps: float, robust: bool = False,
             okf=None):
    """The GN iterations of one level on gathered tiles (with per-pixel
    validity ``okf`` on the raw path); carries the best (lowest-chi2)
    pose.  Returns (T, n_meas int32, H, chi2, iterations run int32).

    A fixed ``n_iter`` loop with a ``done`` mask: once done, every carried
    value is frozen, so this equals the reference's early-exit loop."""
    dev = p_ref.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def residuals(T: SE3):
        p_cur = T.apply(p_ref)
        behind = p_cur[..., 2] <= 1e-6
        uv = cam.world2cam(p_cur) * scale
        vals, usable = _window(tile, uv - PATCH_HALFSIZE - base, okf)
        m = (valid & usable & ~behind)[:, None].expand(-1, PATCH_AREA)
        res = torch.where(m, vals - ref_patch, torch.zeros_like(vals))
        return res, m

    def normal_eqs(res, m):
        mf = m.to(res.dtype)
        if robust:
            # vk::NLLSSolver's optional Tukey weights on the per-pixel
            # residuals, MAD-scaled (sparse_img_align.cpp:82-83, 213-219)
            from rpg_svo_tpu_torch.ops.robust import mad_scale, tukey_weight
            sigma = torch.clamp(mad_scale(res.reshape(-1), m.reshape(-1)),
                                min=1e-3)
            mf = mf * tukey_weight(torch.abs(res) / sigma)
        rm = res * mf
        Jres = -torch.sum(rm[:, :, None] * jac, dim=(0, 1))
        jm = jac * mf[:, :, None]
        H = torch.sum(jac[:, :, :, None] * jm[:, :, None, :], dim=(0, 1))
        chi2 = torch.sum(res * res) / torch.clamp(torch.sum(mf), min=1.0)
        return H, Jres, chi2

    i = torch.zeros((), dtype=torch.int32, device=dev)
    T = best_T = T_init
    best_chi2 = torch.full((), float("inf"), device=dev)
    H_last = torch.zeros((6, 6), device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(n_iter):
        res, m = residuals(T)
        H, Jres, chi2 = normal_eqs(res, m)
        x = solve6x6_spd(H + 1e-8 * eye6, Jres)
        bad = torch.any(torch.isnan(x)) | (chi2 > best_chi2)
        plateau = (i > 0) & (chi2 > best_chi2 * (1.0 - 1e-4))
        T_new = T * SE3.exp(-x)
        better = ~done & (chi2 <= best_chi2)
        best_T = T.where(better, best_T)
        best_chi2 = torch.where(better, chi2, best_chi2)
        stopped = bad & (i > 0)
        T = T.where(done, best_T.where(stopped, T_new))
        converged = (torch.max(torch.abs(x)) < eps) | plateau
        i = torch.where(done, i, i + 1)
        H_last = torch.where(done, H_last, H)
        done = done | converged | stopped
        # on the CPU the remaining masked iterations change nothing, so
        # stop reading them; on the card the check would be a host sync
        if not done.is_cuda and bool(done):
            break
    res, m = residuals(T)
    _, _, chi2 = normal_eqs(res, m)
    better = chi2 <= best_chi2
    T_out = T.where(better, best_T)
    chi2_out = torch.minimum(chi2, best_chi2)
    return T_out, torch.sum(m).to(torch.int32), H_last, chi2_out, i


def _level_gn(cam, T_init: SE3, p_ref, ref_patch, jac, valid, level: int,
              n_iter: int, eps: float, cur_pad, robust: bool = False,
              gather=gather_tiles):
    """GN at one level on the padded current pyramid (tiles gathered around
    the initial projections by ``gather``, the loop in PyTorch ops)."""
    tiles, x0c, y0c = align_kernel.level_tiles(cur_pad, cam, T_init, p_ref,
                                               level, gather)
    base = torch.stack([x0c, y0c], dim=-1).to(torch.float32)
    return _gn_loop(tiles, base, p_ref, ref_patch, jac, valid, T_init, cam,
                    1.0 / (2.0 ** level), n_iter, eps, robust=robust)


def sparse_img_align_plain(ref_pad, cur_pad, cam, T_cur_ref_init: SE3,
                           feats_px, feats_f, feats_depth, feats_valid,
                           max_level: int = 4, min_level: int = 2,
                           n_iter: int = 30, eps: float = 1e-7,
                           robust: bool = False,
                           gather=gather_tiles) -> AlignResult:
    """K2's plain twin, and the path of CPU tensors, other cameras and
    robust weights: per level ``_precompute_level`` then ``_level_gn``.
    Held against K2 on the card, it takes ``gather=gather_tiles_plain``,
    so that no kernel under test computes the reference."""
    T = T_cur_ref_init
    p_ref = feats_f * feats_depth[:, None]
    n_meas = H = chi2 = None
    iters = torch.zeros((MAX_LEVELS,), dtype=torch.int32,
                        device=feats_px.device)
    for level in range(max_level, min_level - 1, -1):
        ref_patch, jac, valid = _precompute_level(
            cam.fx, feats_px, feats_f, feats_depth, feats_valid, level,
            ref_pad, gather)
        T, n_meas, H, chi2, iters[level] = _level_gn(
            cam, T, p_ref, ref_patch, jac, valid, level, n_iter, eps,
            cur_pad, robust=robust, gather=gather)
    n_tracked = torch.div(n_meas, PATCH_AREA, rounding_mode="floor") \
        .to(torch.int32)
    return AlignResult(T, n_tracked, H, chi2, iters)


def sparse_img_align(ref_pad, cur_pad, cam, T_cur_ref_init: SE3,
                     feats_px, feats_f, feats_depth, feats_valid,
                     max_level: int = 4, min_level: int = 2,
                     n_iter: int = 30, eps: float = 1e-7,
                     robust: bool = False) -> AlignResult:
    """Coarse-to-fine sparse image alignment; returns the refined T_cur_ref.

    On CUDA tensors a pinhole camera without robust weights runs all levels
    in one launch of kernel K2; everything else (and every CPU tensor) runs
    ``sparse_img_align_plain``."""
    if align_kernel.use_align_kernel(cam, cur_pad, robust):
        return AlignResult(*align_kernel.sparse_align_kernel(
            ref_pad, cur_pad, cam, T_cur_ref_init, feats_px, feats_f,
            feats_depth, feats_valid, max_level, min_level, n_iter, eps))
    return sparse_img_align_plain(
        ref_pad, cur_pad, cam, T_cur_ref_init, feats_px, feats_f,
        feats_depth, feats_valid, max_level, min_level, n_iter, eps, robust)


def _precompute_level_raw(ref_img, cam_fx: float, feats_px, feats_f,
                          feats_depth, feats_valid, level: int):
    """``_precompute_level`` on a level image: the bordered 6x6 patch is
    36 bilinear samples, and a feature is valid only when all of them are
    inside the level."""
    scale = 1.0 / (2.0 ** level)
    B = PATCH_SIZE + 2
    grid_b = patch_grid(PATCH_HALFSIZE, border=1, device=feats_px.device)
    vals_b, okb = bilinear(ref_img, feats_px[:, None, :] * scale
                           + grid_b[None])
    pb = vals_b.reshape(-1, B, B)
    vals = pb[:, 1:-1, 1:-1].reshape(-1, PATCH_AREA)
    dx = (0.5 * (pb[:, 1:-1, 2:] - pb[:, 1:-1, :-2])).reshape(-1, PATCH_AREA)
    dy = (0.5 * (pb[:, 2:, 1:-1] - pb[:, :-2, 1:-1])).reshape(-1, PATCH_AREA)
    valid = feats_valid & (feats_depth > 1e-6) & torch.all(okb, dim=-1)
    fjac = jacobian_xyz2uv(feats_f * feats_depth[:, None])
    jac = (dx[..., None] * fjac[:, None, 0, :]
           + dy[..., None] * fjac[:, None, 1, :]) * (cam_fx * scale)
    return vals, jac, valid


def _gather_tile_raw(img: torch.Tensor, uv0: torch.Tensor):
    """(TILE, TILE) tile per feature around level coords uv0 (N, 2) from a
    level image, zero and invalid outside it: (base (N, 2) float, tiles,
    okf)."""
    base = torch.floor(uv0).to(torch.int64) - PATCH_HALFSIZE - SLACK
    r = torch.arange(TILE, device=uv0.device)
    xg = base[:, 0, None, None] + r[None, None, :]
    yg = base[:, 1, None, None] + r[None, :, None]
    H, W = img.shape
    ok = (xg >= 0) & (yg >= 0) & (xg < W) & (yg < H)
    idx = torch.clamp(yg, 0, H - 1) * W + torch.clamp(xg, 0, W - 1)
    vals = torch.where(ok, img.reshape(-1)[idx], torch.zeros((), device=
                                                             img.device))
    return base.to(torch.float32), vals, ok


def sparse_img_align_raw(ref_pyr, cur_pyr, cam, T_cur_ref_init: SE3,
                         feats_px, feats_f, feats_depth, feats_valid,
                         max_level: int = 4, min_level: int = 2,
                         n_iter: int = 30, eps: float = 1e-7) -> AlignResult:
    """Coarse-to-fine sparse image alignment on level images (tuples),
    with per-pixel validity: the JAX package's ``cur_pad=None`` path."""
    T = T_cur_ref_init
    p_ref = feats_f * feats_depth[:, None]
    n_meas = H = chi2 = None
    iters = torch.zeros((MAX_LEVELS,), dtype=torch.int32,
                        device=feats_px.device)
    for level in range(max_level, min_level - 1, -1):
        scale = 1.0 / (2.0 ** level)
        ref_patch, jac, valid = _precompute_level_raw(
            ref_pyr[level], cam.fx, feats_px, feats_f, feats_depth,
            feats_valid, level)
        base, tiles, okf = _gather_tile_raw(
            cur_pyr[level], cam.world2cam(T.apply(p_ref)) * scale)
        T, n_meas, H, chi2, iters[level] = _gn_loop(
            tiles, base, p_ref, ref_patch, jac, valid, T, cam, scale, n_iter,
            eps, okf=okf)
    n_tracked = torch.div(n_meas, PATCH_AREA, rounding_mode="floor") \
        .to(torch.int32)
    return AlignResult(T, n_tracked, H, chi2, iters)
