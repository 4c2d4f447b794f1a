"""Bundle adjustment as a batched Gauss-Newton Schur-complement solve.

Port of ``rpg_svo_tpu/ba/schur.py`` (the reference's g2o backend,
svo/src/bundle_adjustment.cpp, with points marginalized as in setupG2o's
BlockSolver_6_3): cameras are the keyframe pool with a ``variable`` mask,
points carry up to M observations (camera index, unit-plane bearing,
pyramid level).  Each iteration builds the variable-camera blocks U, the
point blocks V and the couplings W, forms the reduced camera system
S = U - W V^-1 W^T over the compacted variable cameras, solves it densely
and back-substitutes the points.  Huber weights with information
1/4^level; a step that raises the robust chi2 (or gives NaN) is rolled
back with 8x damping.

The per-camera sums are one-hot matmuls in float32, as the JAX package's
at HIGHEST precision (deterministic, unlike ``index_add``'s atomics on
the card); the per-point couplings ``Y`` are an ``index_add`` in which
only the dropped rows of fixed cameras take more than one observation.
Its
``while_loop`` with the chi2-plateau exit becomes ``n_iter`` masked
iterations whose state freezes once the exit condition holds, so the
solve reads nothing back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from svo_bench.reference.svo.core import graphed
from svo_bench.reference.svo.core.map import mask_compact, set_rows
from svo_bench.reference.svo.geometry.cameras import project2d
from svo_bench.reference.svo.geometry.linalg import inv3x3
from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.ops.robust import huber_weight


class BAProblem(NamedTuple):
    R: torch.Tensor             # (K, 3, 3) T_f_w per camera
    t: torch.Tensor             # (K, 3)
    cam_variable: torch.Tensor  # (K,) bool
    p_w: torch.Tensor           # (P, 3)
    p_valid: torch.Tensor       # (P,) bool
    obs_cam: torch.Tensor       # (P, M) int32 camera index
    obs_f: torch.Tensor         # (P, M, 3) measured unit bearings
    obs_level: torch.Tensor     # (P, M) int32
    obs_mask: torch.Tensor      # (P, M) bool


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    p_w: torch.Tensor
    chi2_init: torch.Tensor
    chi2_final: torch.Tensor
    obs_inlier: torch.Tensor    # (P, M) after the final outlier check


def _apply_cams(R, t, cam, p_w):
    """p_cam (P, M, 3) = R[cam] p + t[cam], with the rows (Rc, tc)."""
    Rc, tc = R[cam], t[cam]
    return torch.sum(Rc * p_w[:, None, None, :], dim=-1) + tc, Rc


def _weights(prob: BAProblem, r, huber_k):
    """Huber weight of the level-scaled residual norm times the
    information 1/4^level; 0 off the masks."""
    sinfo = 1.0 / torch.exp2(prob.obs_level.to(torch.float32))
    rn = torch.linalg.vector_norm(r, dim=-1) * sinfo
    w = huber_weight(rn / max(huber_k, 1e-12)) * sinfo * sinfo
    return torch.where(prob.obs_mask & prob.p_valid[:, None], w,
                       torch.zeros_like(w))


def _chi2(prob: BAProblem, R, t, p_w, huber_k, cam):
    p_cam, _ = _apply_cams(R, t, cam, p_w)
    r = project2d(prob.obs_f) - project2d(p_cam)
    return torch.sum(_weights(prob, r, huber_k) * torch.sum(r * r, -1))


def variable_compaction(variable: torch.Tensor, n_var: int):
    """(vsel (n_var,) camera slots, vok (n_var,), inv_map (K,) slot ->
    compact index, n_var for a fixed camera)."""
    K = variable.shape[0]
    vsel, vok = mask_compact(variable, n_var)
    inv_map = set_rows(torch.full((K,), n_var, dtype=torch.int64,
                                  device=variable.device),
                       vsel, torch.arange(n_var, device=variable.device),
                       vok)
    return vsel, vok, inv_map


def _per_camera(vals, vidx, n_var: int):
    """Sums of vals (P, M, ...) over the observations of each compact
    variable camera: (n_var, ...); fixed cameras (vidx = n_var) drop out.
    A one-hot matmul, as in JAX: on the card ``index_add`` sums with
    atomics in any order, so two runs of a solve (a graph's replay and
    its eager body) would differ in the last bits and the tracks after
    it drift apart."""
    tail = tuple(vals.shape[2:])
    flat = vals.reshape(-1, math.prod(tail))
    onehot = (vidx.reshape(-1, 1) == torch.arange(
        n_var, device=vals.device)).to(vals.dtype)
    return (onehot.T @ flat).reshape((n_var,) + tail)


def build_system(prob: BAProblem, R, t, p_w, huber_k, damping, vidx,
                 n_var: int, cam):
    """One GN iteration's blocks over the compacted variable cameras:
    (U (Vn,6,6), b_c (Vn,6), S_corr (Vn,Vn,6,6), rhs_corr (Vn,6),
    (Vinv (P,3,3), b_p (P,3), Y (P,Vn,6,3)), chi2)."""
    P, M = cam.shape
    p_cam, Rc = _apply_cams(R, t, cam, p_w)
    r = project2d(prob.obs_f) - project2d(p_cam)           # (P, M, 2)
    x, y = p_cam[..., 0], p_cam[..., 1]
    z = p_cam[..., 2]
    z = torch.where(torch.abs(z) < 1e-10, torch.full_like(z, 1e-10), z)
    zi = 1.0 / z
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    # d(residual)/d(camera twist), left-multiplicative (v, w)
    row0 = torch.stack([-zi, zero, x * zi2,
                        y * x * zi2, -(1.0 + x * x * zi2), y * zi], dim=-1)
    row1 = torch.stack([zero, -zi, y * zi2,
                        1.0 + y * y * zi2, -x * y * zi2, -x * zi], dim=-1)
    Jc = torch.stack([row0, row1], dim=-2)                 # (P, M, 2, 6)
    Jproj = torch.stack([
        torch.stack([zi, zero, -x * zi2], dim=-1),
        torch.stack([zero, zi, -y * zi2], dim=-1)], dim=-2)
    Jp = -torch.sum(Jproj[..., :, :, None] * Rc[..., None, :, :], dim=-2)
    w = _weights(prob, r, huber_k)
    chi2 = torch.sum(w * torch.sum(r * r, -1))

    JcW = Jc * w[..., None, None]
    G = torch.sum(JcW[..., :, :, None] * Jc[..., :, None, :], dim=-3)
    U = _per_camera(G, vidx, n_var)
    b_c = -_per_camera(torch.sum(JcW * r[..., None], dim=-2), vidx, n_var)
    V = torch.sum(Jp[..., :, :, None] * Jp[..., :, None, :]
                  * w[..., None, None, None], dim=(1, 2))
    b_p = -torch.sum(Jp * (r * w[..., None])[..., None], dim=(1, 2))
    Wc = torch.sum(JcW[..., :, :, None] * Jp[..., :, None, :], dim=-3)
    eye3 = torch.eye(3, device=p_w.device)
    Vinv = inv3x3(V + (1e-6 + damping) * eye3)
    Vinv = torch.where(prob.p_valid[:, None, None], Vinv,
                       torch.zeros_like(Vinv))
    # Y[p, v] = sum of W over point p's observations in variable camera v
    rows = torch.arange(P, device=cam.device)[:, None] * (n_var + 1) + vidx
    Y = torch.zeros((P * (n_var + 1), 18), device=p_w.device)
    Y = Y.index_add(0, rows.reshape(-1), Wc.reshape(-1, 18))
    Y = Y.reshape(P, n_var + 1, 6, 3)[:, :n_var]
    YV = torch.sum(Y[..., :, :, None] * Vinv[:, None, None, :, :], dim=-2)
    flat = lambda a: a.permute(1, 2, 0, 3).reshape(n_var * 6, P * 3)  # noqa: E731,E501
    S_corr = (flat(YV) @ flat(Y).T).reshape(n_var, 6, n_var, 6) \
        .permute(0, 2, 1, 3)
    rhs_corr = torch.sum(YV * b_p[:, None, None, :], dim=(0, 3))
    return U, b_c, S_corr, rhs_corr, (Vinv, b_p, Y), chi2


def assemble_solve(U, b_c, S_corr, rhs_corr, vok, damping):
    """Dense solve of the compacted reduced camera system (6Vn x 6Vn);
    rows of unused compact slots solve to 0."""
    Vn = U.shape[0]
    dev = U.device
    idx = torch.arange(Vn, device=dev)
    eye6 = torch.eye(6, device=dev)
    S = -S_corr
    S[idx, idx] += U
    mask = (vok[:, None] & vok[None, :])[:, :, None, None]
    S = torch.where(mask, S, torch.zeros_like(S))
    S[idx, idx] += torch.where(vok[:, None, None], damping * eye6, eye6)
    rhs = torch.where(vok[:, None], b_c - rhs_corr, torch.zeros_like(b_c))
    Sd = S.permute(0, 2, 1, 3).reshape(Vn * 6, Vn * 6)
    # solve_ex checks nothing on the host (solve would read back its info)
    dx = torch.linalg.solve_ex(Sd, rhs.reshape(-1, 1),
                               check_errors=False)[0].reshape(Vn, 6)
    return torch.where(vok[:, None], dx, torch.zeros_like(dx))


def expand_dx(dx_v, vsel, vok, K: int):
    """The compact camera updates scattered back to the (K, 6) pool
    layout; fixed cameras get 0."""
    return set_rows(torch.zeros((K, 6), dtype=dx_v.dtype,
                                device=dx_v.device), vsel, dx_v, vok)


def point_backsub(Vinv, b_p, Y, dx_v, p_valid):
    """dx_p = V^-1 (b_p - W^T dx_c[cam]), point by point."""
    Wt_dxc = torch.sum(Y * dx_v[None, :, :, None], dim=(1, 2))   # (P, 3)
    dx_p = torch.sum(Vinv * (b_p - Wt_dxc)[:, None, :], dim=-1)
    return torch.where(p_valid[:, None], dx_p, torch.zeros_like(dx_p))


def _one_device(tree):
    """The sums over points of one device: the tree as it is."""
    return tree


def _gn_step(prob, R, t, p_w, huber_k, damping, vsel, vok, vidx,
             n_var: int, cam, reduce=_one_device):
    """One Schur GN step: (R', t', p_w', chi2 before the step); the
    reduced system and chi2 go through ``reduce`` first."""
    U, b_c, S_corr, rhs_corr, (Vinv, b_p, Y), chi2 = build_system(
        prob, R, t, p_w, huber_k, damping, vidx, n_var, cam)
    U, b_c, S_corr, rhs_corr, chi2 = reduce((U, b_c, S_corr, rhs_corr, chi2))
    dx_v = assemble_solve(U, b_c, S_corr, rhs_corr, vok, damping)
    dx_c = expand_dx(dx_v, vsel, vok, R.shape[0])
    dx_p = point_backsub(Vinv, b_p, Y, dx_v, prob.p_valid)
    T_new = SE3.exp(dx_c) * SE3(R, t)
    return T_new.R, T_new.t, p_w + dx_p, chi2


@graphed.jit(static_argnames=("n_iter", "n_var_max"))
def solve_ba(prob: BAProblem, n_iter: int = 10, huber_width: float = 1.0,
             reproj_thresh_unitplane: float = 0.005,
             n_var_max: int = 0, reduce=_one_device) -> BAResult:
    """Robust GN with chi2 rollback in two phases of n_iter/2 steps, the
    observations with a unit-plane residual above 3x the threshold pruned
    in between; the final inliers are those below the threshold
    (bundle_adjustment.cpp:96-116, 222-250).  n_var_max > 0 bounds the
    variable cameras (the compacted reduced system); 0 lets all K be.

    Every sum over points goes through ``reduce`` (a tree of tensors in,
    the tree of their sums out): the reduced system and chi2 of a step in
    one call, the rollback's chi2 and NaN count in another.  Local BA in
    mesh mode passes the point rows of this rank and an all-reduce over
    their axis; p_w and the inliers then come back as this rank's rows."""
    K = prob.R.shape[0]
    dev = prob.R.device
    n_var = K if not n_var_max else min(K, n_var_max)
    vsel, vok, inv_map = variable_compaction(prob.cam_variable, n_var)
    cam = torch.clamp(prob.obs_cam, 0, K - 1).to(torch.int64)
    vidx = inv_map[cam]
    hk = float(huber_width)
    chi2_init = reduce(_chi2(prob, prob.R, prob.t, prob.p_w, hk, cam))

    def run_phase(pb, n: int, R, t, p, chi2_0):
        """Up to n GN steps; the state freezes once 4 stall points have
        accrued (an accepted step that improves best chi2 by less than
        0.01% adds 2, a rolled-back step 1)."""
        best = chi2_0
        damping = torch.full((), 1e-4, device=dev)
        stall = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(n):
            live = stall < 4
            Rn, tn, pn, chi2 = _gn_step(pb, R, t, p, hk, damping, vsel, vok,
                                        vidx, n_var, cam, reduce)
            chi2_new, n_nan = reduce((
                _chi2(pb, Rn, tn, pn, hk, cam),
                torch.any(torch.isnan(pn)).to(torch.float32)))
            bad = torch.isnan(chi2) | torch.any(torch.isnan(tn)) | (n_nan > 0)
            improve = (chi2_new < best) & ~bad & live
            progress = improve & (best - chi2_new
                                  > 1e-4 * torch.clamp(best, min=1e-30))
            R = torch.where(improve, Rn, R)
            t = torch.where(improve, tn, t)
            p = torch.where(improve, pn, p)
            best = torch.where(improve, chi2_new, best)
            damping = torch.where(
                live, torch.clamp(torch.where(improve, damping * 0.5,
                                              damping * 8.0), 1e-8, 1e2),
                damping)
            stall = torch.where(
                live, torch.where(progress, torch.zeros_like(stall),
                                  stall + torch.where(improve, 2, 1)
                                  .to(torch.int32)), stall)
        return R, t, p, best

    n1 = max(n_iter // 2, 1)
    R, t, p, _ = run_phase(prob, n1, prob.R, prob.t, prob.p_w, chi2_init)
    # prune outlier edges mid-way and re-solve on the inliers
    p_cam, _ = _apply_cams(R, t, cam, p)
    res = project2d(prob.obs_f) - project2d(p_cam)
    keep = prob.obs_mask & (torch.linalg.vector_norm(res, dim=-1)
                            < 3.0 * reproj_thresh_unitplane)
    prob2 = prob._replace(obs_mask=keep)
    chi2_1 = reduce(_chi2(prob2, R, t, p, hk, cam))
    R, t, p, chi2_final = run_phase(prob2, n_iter - n1, R, t, p, chi2_1)
    p_cam, _ = _apply_cams(R, t, cam, p)
    res = project2d(prob.obs_f) - project2d(p_cam)
    inlier = prob.obs_mask & (torch.linalg.vector_norm(res, dim=-1)
                              < reproj_thresh_unitplane) \
        & (p_cam[..., 2] > 0)
    return BAResult(R, t, p, chi2_init, chi2_final, inlier)
