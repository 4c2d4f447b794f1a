"""Motion-only bundle adjustment (pose refinement).

Port of ``rpg_svo_tpu/ops/pose_opt.py`` (pose_optimizer::optimizeGaussNewton,
svo/src/pose_optimizer.cpp:28-161): unit-plane residuals scaled by
1/2^level, Tukey weights with MAD scale (0.85/fx from iteration 5),
chi2-increase rollback and NaN guard, left-multiplicative update
T <- exp(dT) T, covariance (A fx^2)^-1, outlier pruning on the final
residuals.  A fixed loop with a ``done`` mask, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_bench.reference.svo.core import graphed
from svo_bench.reference.svo.geometry.cameras import project2d
from svo_bench.reference.svo.geometry.linalg import solve6x6_spd
from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.geometry.triangulation import jacobian_xyz2uv
from svo_bench.reference.svo.ops.robust import mad_scale, masked_median, tukey_weight

EPS = 1e-10


class PoseOptResult(NamedTuple):
    T_f_w: SE3
    cov: torch.Tensor          # (6, 6)
    inliers: torch.Tensor      # (N,)
    n_obs: torch.Tensor        # int32
    error_init: torch.Tensor   # median initial error, px
    error_final: torch.Tensor  # median final error, px
    estimated_scale: torch.Tensor


def _residuals(T: SE3, p_w, f_meas, sqrt_inv_cov, valid):
    p_cam = T.apply(p_w)
    e = (project2d(f_meas) - project2d(p_cam)) * sqrt_inv_cov[:, None]
    return torch.where(valid[:, None], e, torch.zeros_like(e)), p_cam


@graphed.jit(static_argnames=("n_iter",))
def optimize_pose(T_init: SE3, p_w, f_meas, level, valid, fx: float,
                  reproj_thresh: float = 2.0,
                  n_iter: int = 10) -> PoseOptResult:
    dev = p_w.device
    eye6 = torch.eye(6, device=dev)
    sqrt_inv_cov = 1.0 / torch.exp2(level.to(torch.float32))

    e0, _ = _residuals(T_init, p_w, f_meas, sqrt_inv_cov, valid)
    est_scale = mad_scale(torch.linalg.vector_norm(e0, dim=-1), valid)
    error_init = torch.sqrt(masked_median(torch.sum(e0 * e0, -1),
                                          valid)) * fx

    def gn_system(T, scale):
        e, p_cam = _residuals(T, p_w, f_meas, sqrt_inv_cov, valid)
        J = jacobian_xyz2uv(p_cam) * sqrt_inv_cov[:, None, None]
        w = tukey_weight(torch.linalg.vector_norm(e, dim=-1)
                         / torch.clamp(scale, min=1e-12))
        w = torch.where(valid, w, torch.zeros_like(w))
        Jw = J * w[:, None, None]
        A = torch.sum(J[:, :, :, None] * Jw[:, :, None, :], dim=(0, 1))
        b = -torch.sum(Jw * e[:, :, None], dim=(0, 1))
        chi2 = torch.sum(torch.sum(e * e, -1) * w)
        return A, b, chi2

    T = T_old = T_init
    chi2_prev = torch.zeros((), device=dev)
    A_prev = eye6
    done = torch.zeros((), dtype=torch.bool, device=dev)
    late_scale = torch.full((), 0.85, device=dev) / fx
    for i in range(n_iter):
        scale = late_scale if i >= 5 else est_scale
        A, b, new_chi2 = gn_system(T, scale)
        dT = solve6x6_spd(A + 1e-12 * eye6, b)
        fail = ~done & ((i > 0) & (new_chi2 > chi2_prev)
                        | torch.isnan(dT[0]))
        upd = ~done & ~fail
        T_next = T_old.where(fail, (SE3.exp(dT) * T).where(upd, T))
        T_old = T.where(upd, T_old)
        T = T_next
        converged = torch.max(torch.abs(dT)) <= EPS
        chi2_prev = torch.where(upd, new_chi2, chi2_prev)
        A_prev = torch.where(upd, A, A_prev)
        done = done | fail | (upd & converged)

    cov = torch.linalg.inv_ex(A_prev * (fx * fx) + 1e-12 * eye6)[0]
    e1, _ = _residuals(T, p_w, f_meas, sqrt_inv_cov, valid)
    inliers = valid & (torch.linalg.vector_norm(e1, dim=-1)
                       <= reproj_thresh / fx)
    error_final = torch.sqrt(masked_median(torch.sum(e1 * e1, -1),
                                           valid)) * fx
    return PoseOptResult(T, cov, inliers, torch.sum(inliers).to(torch.int32),
                         error_init, error_final, est_scale * fx)
