"""Distributed Schur-complement bundle adjustment over a mesh.

Port of ``rpg_svo_tpu/parallel/ba.py`` to ``torch.distributed``.  Keyframe
camera blocks are replicated; POINT blocks and their observations are
sharded over ``axis``: each rank builds the partial reduced camera system
from its points with the single-device block builder
(``ba/schur.build_system``, with its variable-camera compaction), ONE
all-reduce sums S and the rhs, every rank solves the same small dense
system, and the point back-substitution stays local.  Per GN iteration
the ranks exchange one all-reduce of the reduced system (U, b_c, S_corr,
rhs_corr: 36 Vn^2 + 48 Vn floats, Vn the compacted variable-camera count,
independent of the number of points) and one of the chi2 rollback's sum.

Equal to the single-device solver up to the order of the sums.
"""

from __future__ import annotations

import torch

from rpg_svo_tpu_torch.ba.schur import (
    BAProblem, _chi2, assemble_solve, build_system, expand_dx,
    point_backsub, variable_compaction)
from rpg_svo_tpu_torch.core import graphed
from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.parallel.gspmd import psum, use_mesh


@graphed.jit(static_argnames=("mesh", "n_iter", "axis", "n_var_max"))
def distributed_ba_solve(mesh, prob: BAProblem, n_iter: int = 10,
                         huber_width: float = 0.01, axis="sp",
                         n_var_max: int = 0):
    """GN + Schur BA with the points sharded over ``axis`` of ``mesh``.

    prob's p_w, p_valid and obs_* are this rank's point rows; R, t and
    cam_variable are whole on every rank.  Returns (R, t, p_w, chi2): the
    cameras and chi2 replicated, p_w this rank's rows."""
    K = prob.R.shape[0]
    dev = prob.R.device
    n_var = K if not n_var_max else min(K, n_var_max)
    # replicated: every rank computes the same compaction
    vsel, vok, inv_map = variable_compaction(prob.cam_variable, n_var)
    cam = torch.clamp(prob.obs_cam, 0, K - 1).to(torch.int64)
    vidx = inv_map[cam]
    hk = float(huber_width)
    R, t, p = prob.R, prob.t, prob.p_w
    with use_mesh(mesh):
        best = psum(_chi2(prob, R, t, p, hk, cam), axis)
        damping = torch.full((), 1e-4, device=dev)
        for _ in range(n_iter):
            U, b_c, S_corr, rhs_corr, (Vinv, b_p, Y), _ = build_system(
                prob, R, t, p, hk, damping, vidx, n_var, cam)
            U, b_c, S_corr, rhs_corr = psum((U, b_c, S_corr, rhs_corr),
                                            axis)
            dx_v = assemble_solve(U, b_c, S_corr, rhs_corr, vok, damping)
            dx_c = expand_dx(dx_v, vsel, vok, K)
            dx_p = point_backsub(Vinv, b_p, Y, dx_v, prob.p_valid)
            T_new = SE3.exp(dx_c) * SE3(R, t)
            p_new = p + dx_p
            # chi2 rollback (a global sum)
            chi2_new = psum(_chi2(prob, T_new.R, T_new.t, p_new, hk, cam),
                            axis)
            ok = (chi2_new < best) & torch.isfinite(chi2_new)
            R = torch.where(ok, T_new.R, R)
            t = torch.where(ok, T_new.t, t)
            p = torch.where(ok, p_new, p)
            best = torch.where(ok, chi2_new, best)
            damping = torch.clamp(torch.where(ok, damping * 0.5,
                                              damping * 8.0), 1e-8, 1e2)
    return R, t, p, best
