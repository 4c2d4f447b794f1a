"""Structure-only refinement: per-point 3-DoF Gauss-Newton.

Port of ``rpg_svo_tpu/ops/point_opt.py`` (Point::optimize,
svo/src/point.cpp:119-177): all selected points run one batched GN with
per-point chi2 rollback and convergence freezing.  K points, M observation
slots each: obs_R (K, M, 3, 3), obs_t (K, M, 3) the observing keyframes'
T_f_w, obs_f (K, M, 3) measured bearings, obs_mask (K, M).
"""

from __future__ import annotations

from typing import Tuple

import torch

from svo_bench.reference.svo.core import graphed
from svo_bench.reference.svo.geometry.cameras import project2d
from svo_bench.reference.svo.geometry.linalg import solve3x3

EPS = 1e-10


def _point_system(p_w, obs_R, obs_t, obs_f, obs_mask):
    """Batched 3x3 normal equations: A (K, 3, 3), b (K, 3), chi2 (K,)."""
    p_cam = torch.sum(obs_R * p_w[:, None, None, :], dim=-1) + obs_t
    e = project2d(obs_f) - project2d(p_cam)
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    z = torch.where(torch.abs(z) < 1e-10, torch.full_like(z, 1e-10), z)
    zi = 1.0 / z
    zero = torch.zeros_like(x)
    Jproj = torch.stack([
        torch.stack([zi, zero, -x * zi * zi], dim=-1),
        torch.stack([zero, zi, -y * zi * zi], dim=-1),
    ], dim=-2)
    J = -torch.sum(Jproj[..., :, :, None] * obs_R[..., None, :, :], dim=-2)
    m = obs_mask.to(e.dtype)
    e = e * m[..., None]
    Jm = J * m[..., None, None]
    A = torch.sum(J[..., :, :, None] * Jm[..., :, None, :], dim=(1, 2))
    b = -torch.sum(Jm * e[..., None], dim=(1, 2))
    chi2 = torch.sum(torch.sum(e * e, -1), dim=-1)
    return A, b, chi2


@graphed.jit(static_argnames=("n_iter",))
def optimize_points(p_w, obs_R, obs_t, obs_f, obs_mask, point_valid,
                    n_iter: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (optimized p_w (K, 3), final chi2 (K,))."""
    eye3 = torch.eye(3, device=p_w.device)
    p = p_old = p_w
    chi2_old = torch.full((p_w.shape[0],), float("inf"), device=p_w.device)
    frozen = torch.zeros((p_w.shape[0],), dtype=torch.bool,
                         device=p_w.device)
    for _ in range(n_iter):
        A, b, chi2 = _point_system(p, obs_R, obs_t, obs_f, obs_mask)
        dp = solve3x3(A + 1e-10 * eye3, b)
        bad = (chi2 > chi2_old) | torch.isnan(dp[:, 0])
        # rollback per point; once rolled back, freeze (reference breaks)
        p_next = torch.where((bad | frozen | ~point_valid)[:, None],
                             torch.where(bad[:, None], p_old, p), p + dp)
        conv = torch.max(torch.abs(dp), dim=-1).values <= EPS
        p_old = torch.where(bad[:, None], p_old, p)
        chi2_old = torch.where(bad, chi2_old, chi2)
        frozen = frozen | bad | conv
        p = p_next
    return p, chi2_old


def observations_struct(n_points: int, max_obs: int, device="cpu"):
    """Empty observation struct-of-arrays block for ``optimize_points``."""
    shape = (n_points, max_obs)
    return dict(
        obs_R=torch.eye(3, device=device).expand(*shape, 3, 3).clone(),
        obs_t=torch.zeros((*shape, 3), device=device),
        obs_f=torch.tensor([0.0, 0.0, 1.0], device=device)
        .expand(*shape, 3).clone(),
        obs_mask=torch.zeros(shape, dtype=torch.bool, device=device))
