"""Probabilistic depth filter: Bayesian inverse-depth seeds, batched.

Port of ``rpg_svo_tpu/core/depth_filter.py`` (DepthFilter and Seed,
svo/src/depth_filter.cpp).  The whole seed pool updates in one batched
pass per frame:

- seed init: a = b = 10, mu = 1/depth_mean, z_range = 1/depth_min,
  sigma2 = (z_range/6)^2 (depth_filter.cpp:37-46), with the keyframe
  counter as the batch id;
- aging: seeds older than max_n_kfs keyframes drop (:216-219);
- visible seeds search the epipolar segment mu +/- sqrt(sigma2)
  (:222-242), reference patches warped out of their creation-time tiles;
- a failed search adds outlier evidence b += 1 (:243-247);
- tau from the 1-px angular error (computeTau, :334-350) and the
  Vogiatzis-Hernandez update (updateSeed, :309-332);
- convergence, sqrt(sigma2) < z_range / thresh, turns the seed into a
  CANDIDATE point (:260-282); a non-finite seed is pruned (:283-287).

``update_k`` compacts the eligible seeds to that many (least-served first,
then the rest in index order, with the JAX package's exact order) before
the search, so its cost follows the live seeds.  In mesh mode
(``shard_axis``, parallel/fused_mesh.py) each rank matches its rows of
that K-domain and the matches are all-gathered before the update.  The
fused step runs the update every frame and keeps or drops its result with
a select (the JAX step's ``lax.cond``); nothing reads a value back to the
host.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from svo_bench.reference.svo.core import graphed
from svo_bench.reference.svo.core.map import (
    TYPE_CANDIDATE, MapState, SeedStore, alloc_points, as_flag, free_slots,
    mask_compact, set_rows)
from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.ops.detector import detect_features
from svo_bench.reference.svo.ops.matcher import (
    epipolar_geometry, epipolar_search, long_table_rows,
    warp_affine_patches_tiles, warp_rotated_tiles)
from svo_bench.reference.svo.ops.patches import empty_tiles, extract_tiles
from svo_bench.reference.svo.parallel.gspmd import gather_dim0, shard_dim0

INIT_A = 10.0
INIT_B = 10.0
ALLOC_K = 256   # max candidate points allocated per frame
I32 = torch.int32


class SeedUpdateStats(NamedTuple):
    n_updated: torch.Tensor
    n_failed: torch.Tensor
    n_converged: torch.Tensor
    n_seeds: torch.Tensor


def _cmax(x, v: float):
    return torch.clamp(x, min=v)


def seed_variance_update(mu, sigma2, a, b, z_range, x, tau2):
    """Vogiatzis-Hernandez Bayesian update (depth_filter.cpp:309-332);
    all (S,).  Returns (mu', sigma2', a', b'), the old values where any
    new one is not finite."""
    norm_scale2 = sigma2 + tau2
    norm_scale = torch.sqrt(_cmax(norm_scale2, 1e-20))
    s2 = 1.0 / (1.0 / _cmax(sigma2, 1e-20) + 1.0 / _cmax(tau2, 1e-20))
    m = s2 * (mu / _cmax(sigma2, 1e-20) + x / _cmax(tau2, 1e-20))
    pdf = torch.exp(-0.5 * ((x - mu) / norm_scale) ** 2) \
        / (norm_scale * math.sqrt(2.0 * math.pi))
    C1 = a / (a + b) * pdf
    C2 = b / (a + b) / _cmax(z_range, 1e-20)
    norm = _cmax(C1 + C2, 1e-20)
    C1 = C1 / norm
    C2 = C2 / norm
    f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0)) \
        + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0))
    mu_new = C1 * m + C2 * mu
    sigma2_new = C1 * (s2 + m * m) + C2 * (sigma2 + mu * mu) \
        - mu_new * mu_new
    den = f - e / _cmax(f, 1e-20)
    a_new = (e - f) / torch.where(torch.abs(den) < 1e-20,
                                  torch.full_like(den, 1e-20), den)
    b_new = a_new * (1.0 - f) / _cmax(f, 1e-20)
    ok = torch.isfinite(mu_new) & torch.isfinite(sigma2_new) \
        & torch.isfinite(a_new) & torch.isfinite(b_new)
    return (torch.where(ok, mu_new, mu), torch.where(ok, sigma2_new, sigma2),
            torch.where(ok, a_new, a), torch.where(ok, b_new, b))


def compute_tau(T_ref_cur_t: torch.Tensor, f: torch.Tensor, z: torch.Tensor,
                px_error_angle) -> torch.Tensor:
    """Depth std of a 1-px angular error (computeTau)."""
    t = T_ref_cur_t
    a = f * z[:, None] - t
    t_norm = torch.linalg.vector_norm(t, dim=-1)
    a_norm = torch.linalg.vector_norm(a, dim=-1)
    alpha = torch.arccos(torch.clamp(
        torch.sum(f * t, -1) / _cmax(t_norm, 1e-12), -1.0, 1.0))
    beta = torch.arccos(torch.clamp(
        torch.sum(a * (-t), -1) / _cmax(t_norm * a_norm, 1e-12), -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma_plus = math.pi - alpha - beta_plus
    sin_g = torch.sin(gamma_plus)
    z_plus = t_norm * torch.sin(beta_plus) / torch.where(
        torch.abs(sin_g) < 1e-12, torch.full_like(sin_g, 1e-12), sin_g)
    return z_plus - z


def _seed_poses(m: MapState, T_cur_w: SE3):
    """(T_kf_w, T_cur_ref) of every seed's origin keyframe, batched (S,)."""
    kf_idx = torch.clamp(m.seed.kf_slot, 0, m.kf.R.shape[0] - 1) \
        .to(torch.int64)
    T_kf_w = SE3(m.kf.R[kf_idx], m.kf.t[kf_idx])
    return T_kf_w, T_cur_w * T_kf_w.inverse()


def _visible(seed: SeedStore, T_cur_ref: SE3, cam) -> torch.Tensor:
    p_cur = T_cur_ref.apply(seed.f / _cmax(seed.mu, 1e-8)[:, None])
    return (p_cur[..., 2] > 0.0) & cam.is_in_frame(cam.world2cam(p_cur))


def has_update_work(m: MapState, T_cur_w: SE3, cam,
                    max_n_kfs: int = 3) -> torch.Tensor:
    """0-d bool: some active seed is young enough and visible, or some
    active seed has aged out and must be pruned."""
    seed = m.seed
    too_old = (m.kf_counter - seed.batch_id) > max_n_kfs
    _, T_cur_ref = _seed_poses(m, T_cur_w)
    visible = _visible(seed, T_cur_ref, cam)
    return torch.any(seed.active & ~too_old & visible) \
        | torch.any(seed.active & too_old)


def init_seeds_from_detection(m: MapState, kf_slot: torch.Tensor, det: dict,
                              cam, depth_mean: torch.Tensor,
                              depth_min: torch.Tensor,
                              min_score: float = 20.0,
                              enable=True, inplace: bool = False) -> MapState:
    """One seed per good detection (score above min_score) in the first
    free seed slots; ``enable`` (a 0-d bool tensor or a bool) masks the
    whole call, the keyframe counter included.  Only allocated rows are
    written, into the seed pool itself with ``inplace``."""
    dev = det["px"].device
    enable = as_flag(enable, dev)
    good = det["valid"] & (det["score"] > min_score) & enable
    n = good.shape[0]
    kf_counter = m.kf_counter + enable.to(I32)
    if "tile" in det:
        tile, tile_xy0 = det["tile"], det["tile_xy0"]
    else:
        tile, tile_xy0 = empty_tiles(n, dev)
    seed = m.seed
    slots = free_slots(seed.active[:-1], n)
    slots = torch.where(good, slots, torch.full_like(slots, -1))
    ok = slots >= 0
    f = cam.cam2world(det["px"])
    z_range = 1.0 / _cmax(depth_min, 1e-6)
    one = torch.ones((n,), device=dev)
    zi = torch.zeros((n,), dtype=I32, device=dev)

    def put(arr, val):
        return set_rows(arr, slots, val.to(arr.dtype), ok, inplace)

    seed = seed._replace(
        active=put(seed.active, torch.ones_like(good)),
        kf_slot=put(seed.kf_slot, zi + kf_slot.to(I32)),
        batch_id=put(seed.batch_id, zi + kf_counter),
        px=put(seed.px, det["px"]),
        f=put(seed.f, f),
        level=put(seed.level, det["level"]),
        a=put(seed.a, one * INIT_A),
        b=put(seed.b, one * INIT_B),
        mu=put(seed.mu, one / _cmax(depth_mean, 1e-6)),
        z_range=put(seed.z_range, one * z_range),
        sigma2=put(seed.sigma2, one * (z_range * z_range / 36.0)),
        ftype=put(seed.ftype, zi),
        grad=put(seed.grad, torch.stack([one, one * 0.0], dim=-1)),
        tile=put(seed.tile, tile),
        tile_xy0=put(seed.tile_xy0, tile_xy0),
        upd_count=put(seed.upd_count, zi),
    )
    return m._replace(seed=seed, kf_counter=kf_counter)


@graphed.jit(static_argnames=("cell_size", "min_score", "det_levels",
                              "max_per_kf"))
def init_seeds(m: MapState, kf_slot: torch.Tensor, pad, cam,
               occupied: torch.Tensor, depth_mean: torch.Tensor,
               depth_min: torch.Tensor, cell_size: int,
               min_score: float = 20.0, det_levels: int = 3,
               max_per_kf: int = 0) -> MapState:
    """DepthFilter::initializeSeeds: detect corners on the first
    ``det_levels`` levels of the keyframe's padded pyramid, away from the
    occupied cells, and seed one per new corner (compacted to max_per_kf
    rows first, when that is fewer than the cells); increments the
    keyframe counter."""
    det = detect_features(pad.levels()[:det_levels], occupied, cell_size)
    if max_per_kf and max_per_kf < det["valid"].shape[0]:
        good = det["valid"] & (det["score"] > min_score)
        sel, ok = mask_compact(good, max_per_kf)
        det = {"px": det["px"][sel], "score": det["score"][sel],
               "level": det["level"][sel], "valid": ok}
    tile, tile_xy0 = extract_tiles(pad, det["px"], det["level"])
    det = dict(det, tile=tile, tile_xy0=tile_xy0)
    return init_seeds_from_detection(m, kf_slot, det, cam, depth_mean,
                                     depth_min, min_score=min_score)


class SeedFieldUpdate(NamedTuple):
    """Everything one seed update changes, as (S,)-sized fields; the point
    allocation is applied by ``apply_seed_update``."""
    active: torch.Tensor     # (S,)
    mu: torch.Tensor         # (S,)
    sigma2: torch.Tensor     # (S,)
    a: torch.Tensor          # (S,)
    b: torch.Tensor          # (S,)
    converged: torch.Tensor  # (S,) -> allocate a CANDIDATE point
    p_w: torch.Tensor        # (S, 3) world position of converged seeds
    upd_count: torch.Tensor  # (S,) int32 service counter
    stats: SeedUpdateStats


def identity_seed_update(seed: SeedStore) -> SeedFieldUpdate:
    """The no-op update."""
    z = torch.zeros((), dtype=I32, device=seed.active.device)
    return SeedFieldUpdate(
        seed.active, seed.mu, seed.sigma2, seed.a, seed.b,
        torch.zeros_like(seed.active), torch.zeros_like(seed.f),
        seed.upd_count,
        SeedUpdateStats(z, z, z, torch.sum(seed.active).to(I32)))


def select_seed_update(cond: torch.Tensor, upd: SeedFieldUpdate,
                       other: SeedFieldUpdate) -> SeedFieldUpdate:
    """upd where the 0-d ``cond`` holds, else other (the JAX lax.cond)."""
    sel = lambda a, b: torch.where(cond, a, b)  # noqa: E731
    return SeedFieldUpdate(
        *[sel(a, b) for a, b in zip(upd[:-1], other[:-1])],
        SeedUpdateStats(*[sel(a, b) for a, b in zip(upd.stats,
                                                      other.stats)]))


def apply_seed_update(m: MapState, upd: SeedFieldUpdate,
                      inplace: bool = False) -> MapState:
    """Write the seed fields back and allocate a CANDIDATE point for each
    converged seed, at most ALLOC_K per call in seed order; converged seeds
    past the cap stay alive and convert later.  With ``inplace`` the
    points are allocated in the point pool itself."""
    seed = m.seed
    S = upd.converged.shape[0]
    order, conv_c = mask_compact(upd.converged, ALLOC_K)
    pt, _ = alloc_points(
        m.pt, upd.p_w[order], TYPE_CANDIDATE, seed.kf_slot[order],
        seed.px[order], seed.f[order], seed.level[order], conv_c,
        orig_type=seed.ftype[order], orig_grad=seed.grad[order],
        orig_tile=seed.tile[order], orig_tile_xy0=seed.tile_xy0[order],
        inplace=inplace)
    allocated = set_rows(torch.zeros((S,), dtype=torch.bool,
                                     device=conv_c.device),
                         order, conv_c, conv_c)
    active = upd.active | (upd.converged & ~allocated)
    seed = seed._replace(active=active, mu=upd.mu, sigma2=upd.sigma2,
                         a=upd.a, b=upd.b, upd_count=upd.upd_count)
    return m._replace(seed=seed, pt=pt)


@graphed.jit(static_argnames=("max_n_kfs", "conv_thresh", "max_steps",
                              "update_k", "short_steps", "long_k",
                              "max_level", "scan_rows"))
def update_seeds(m: MapState, cur_pad, T_cur_w: SE3, cam,
                 max_n_kfs: int = 3, conv_thresh: float = 200.0,
                 max_steps: int = 256, update_k: int = 0,
                 short_steps: int = 0, long_k: int = 0, max_level: int = 2,
                 scan_rows: int = 8):
    """One update of all active seeds against the current frame, applied:
    (map, stats)."""
    upd = update_seeds_fields(
        m, cur_pad, T_cur_w, cam, max_n_kfs=max_n_kfs,
        conv_thresh=conv_thresh, max_steps=max_steps, update_k=update_k,
        short_steps=short_steps, long_k=long_k, max_level=max_level,
        scan_rows=scan_rows)
    return apply_seed_update(m, upd), upd.stats


def _pick_long_over(long, long_k: int, axis: str):
    """``long_table_rows`` over the whole domain sharded over ``axis``
    (one all-gather of the long mask): this rank's rows of the long
    segments the whole table holds, and the row count on this rank."""
    long_all = gather_dim0(long, axis)
    _, kl = long_table_rows(long_all, long_k)
    gsel, gok = mask_compact(long_all, kl)
    return (shard_dim0(set_rows(torch.zeros_like(long_all), gsel, gok, gok),
                       axis), min(kl, long.shape[0]))


def update_seeds_fields(m: MapState, cur_pad, T_cur_w: SE3, cam,
                        max_n_kfs: int = 3, conv_thresh: float = 200.0,
                        max_steps: int = 256, update_k: int = 0,
                        enable=True, short_steps: int = 0, long_k: int = 0,
                        max_level: int = 2, scan_rows: int = 8,
                        shard_axis: str = "") -> SeedFieldUpdate:
    """One batched update of all active seeds against the current frame
    (its padded pyramid ``cur_pad``); returns the field deltas.

    ``update_k`` > 0 (and < the pool) compacts the eligible seeds to that
    many before the search: the least-served seeds first (minimum
    ``upd_count``), then the other eligible seeds in index order; the
    rest skip this frame without evidence.  ``enable`` (0-d bool tensor or
    bool) masks the update: when False the fields come back unchanged.
    ``shard_axis`` (with ``update_k``) shards the K-domain match over that
    axis of the ambient mesh."""
    seed = m.seed
    S = seed.active.shape[0]
    dev = seed.active.device
    enable = as_flag(enable, dev)

    too_old = (m.kf_counter - seed.batch_id) > max_n_kfs
    active = seed.active & ~too_old
    T_kf_w, T_cur_ref = _seed_poses(m, T_cur_w)
    T_ref_cur = T_cur_ref.inverse()
    mu_safe = _cmax(seed.mu, 1e-8)
    eligible = active & _visible(seed, T_cur_ref, cam) & enable

    # the epipolar search range in inverse depth (:236-238)
    sig = torch.sqrt(_cmax(seed.sigma2, 0.0))
    z_inv_min = seed.mu + sig
    z_inv_max = _cmax(seed.mu - sig, 1e-8)
    d_min = 1.0 / _cmax(z_inv_min, 1e-8)
    d_max = 1.0 / z_inv_max
    px_error_angle = math.atan(1.0 / (2.0 * cam.fx)) * 2.0

    def match(idx, elig, pick_long=long_table_rows):
        """Epipolar match of the seeds ``idx`` (ref patches from their
        creation-time tiles): (depth_ref, success, scanned)."""
        T_cr = SE3(T_cur_ref.R[idx], T_cur_ref.t[idx])
        px, level = seed.px[idx], seed.level[idx]
        tile, xy0 = seed.tile[idx], seed.tile_xy0[idx]
        geom = epipolar_geometry(cam, T_cr, px, seed.f[idx], level,
                                 (1.0 / mu_safe)[idx], d_min[idx],
                                 d_max[idx], max_steps=max_steps,
                                 max_level=max_level)
        ref_b, okb = warp_affine_patches_tiles(geom.A, tile, xy0, px, level,
                                               geom.search_level)
        ref_r, okr = warp_rotated_tiles(geom.A, tile, xy0, px, level,
                                        geom.search_level, geom.dir_lvl)
        mm = epipolar_search(
            cur_pad, cam, geom, T_cr, seed.f[idx], ref_b, ref_r, okb & okr,
            elig, max_steps=max_steps, ftr_type=seed.ftype[idx],
            ftr_grad=seed.grad[idx], short_steps=short_steps, long_k=long_k,
            scan_rows=scan_rows, pick_long=pick_long)
        return mm.depth_ref, mm.success, mm.scanned

    def bayes(idx, depth, matched, failed):
        """tau, the Bayesian update and convergence of seeds ``idx``:
        (mu, sigma2, a, b, converged, p_w, nan)."""
        b_base = torch.where(failed, seed.b[idx] + 1.0, seed.b[idx])
        z = _cmax(depth, 1e-8)
        tau = compute_tau(T_ref_cur.t[idx], seed.f[idx], z, px_error_angle)
        tau_inv = 0.5 * (1.0 / torch.clamp(z - tau, min=1e-7)
                         - 1.0 / (z + tau))
        mu0, s20, a0 = seed.mu[idx], seed.sigma2[idx], seed.a[idx]
        mu2, s22, a2, b2 = seed_variance_update(
            mu0, s20, a0, b_base, seed.z_range[idx], 1.0 / z,
            tau_inv * tau_inv)
        mu = torch.where(matched, mu2, mu0)
        sigma2 = torch.where(matched, s22, s20)
        a = torch.where(matched, a2, a0)
        b = torch.where(matched, b2, b_base)
        conv = matched & (torch.sqrt(_cmax(sigma2, 0.0))
                          < seed.z_range[idx] / conv_thresh)
        T_w_kf = SE3(T_kf_w.R[idx], T_kf_w.t[idx]).inverse()
        p_w = T_w_kf.apply(seed.f[idx] / _cmax(mu, 1e-8)[:, None])
        nan = ~torch.isfinite(z_inv_min[idx]) | ~torch.isfinite(mu)
        return mu, sigma2, a, b, conv, p_w, nan

    if update_k and update_k < S:
        K = update_k
        ev = seed.upd_count
        ev_min = torch.amin(torch.where(
            eligible, ev, torch.full_like(ev, torch.iinfo(torch.int32).max)))
        prio = eligible & (ev == ev_min)
        sel1, v1 = mask_compact(prio, K)
        sel2, v2 = mask_compact(eligible & ~prio, K)
        n1 = torch.sum(v1)
        j = torch.arange(K, device=dev)
        fill = sel2[torch.clamp(j - n1, 0, K - 1)]
        sel = torch.where(v1, sel1, fill)
        elig_c = v1 | ((j - n1 >= 0) & (j - n1 < torch.sum(v2)))
        sel = torch.where(elig_c, sel, torch.zeros_like(sel))
        if shard_axis:
            # mesh mode: this rank matches its rows of the K-domain (each
            # reads the whole current pyramid); the rows' results are
            # all-gathered for the update; the long-segment table is picked
            # over the whole domain, so every row scans as on one device
            depth, succ, scanned = gather_dim0(
                match(*shard_dim0((sel, elig_c), shard_axis),
                      functools.partial(_pick_long_over, axis=shard_axis)),
                shard_axis)
        else:
            depth, succ, scanned = match(sel, elig_c)
        matched = succ & elig_c
        failed = elig_c & ~succ & scanned
        mu_k, s2_k, a_k, b_k, conv_k, p_w_k, nan_k = bayes(
            sel, depth, matched, failed)
        # write back the selected rows only
        put = lambda base, val: set_rows(base, sel, val, elig_c)  # noqa: E731
        mu_out = put(seed.mu, mu_k)
        sigma2_out = put(seed.sigma2, s2_k)
        a_out = put(seed.a, a_k)
        b_out = put(seed.b, b_k)
        cnt_out = put(seed.upd_count, seed.upd_count[sel] + 1)
        converged = put(torch.zeros_like(seed.active), conv_k)
        p_w = put(torch.zeros_like(seed.f), p_w_k)
        dead = put(torch.zeros_like(seed.active), (conv_k | nan_k) & elig_c)
        active_out = torch.where(enable, active & ~dead, seed.active)
    else:
        ar = torch.arange(S, device=dev)
        depth, succ, scanned = match(ar, eligible)
        matched = eligible & succ
        failed = eligible & ~succ & scanned
        mu_out, sigma2_out, a_out, b_out, converged, p_w, nan = bayes(
            ar, depth, matched, failed)
        active_out = torch.where(enable, active & ~converged & ~nan,
                                 seed.active)
        cnt_out = seed.upd_count + eligible.to(I32)
    stats = SeedUpdateStats(
        n_updated=torch.sum(matched).to(I32),
        n_failed=torch.sum(failed).to(I32),
        n_converged=torch.sum(converged).to(I32),
        n_seeds=torch.sum(active_out).to(I32))
    return SeedFieldUpdate(active_out, mu_out, sigma2_out, a_out, b_out,
                           converged, p_w, cnt_out, stats)
