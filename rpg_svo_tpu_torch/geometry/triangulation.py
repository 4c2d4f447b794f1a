"""Triangulation and projection Jacobians.

Port of ``rpg_svo_tpu/geometry/triangulation.py``: the reference's
``Frame::jacobian_xyz2uv`` (svo/include/svo/frame.h:116-138),
``Matcher::depthFromTriangulation`` (svo/src/matcher.cpp:109-122) and the
bootstrap's midpoint triangulation.
"""

from __future__ import annotations

import torch

from rpg_svo_tpu_torch.geometry.se3 import SE3


def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-10,
                             torch.full_like(z, 1e-10), z)


def jacobian_xyz2uv(p_cam: torch.Tensor) -> torch.Tensor:
    """d(unit-plane residual)/d(twist), twist (v, w); (..., 3) -> (..., 2, 6)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zi = _inv_z(z)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([-zi, zero, x * zi2,
                        y * x * zi2, -(1.0 + x * x * zi2), y * zi], dim=-1)
    row1 = torch.stack([zero, -zi, y * zi2,
                        1.0 + y * y * zi2, -x * y * zi2, -x * zi], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def depth_from_triangulation(T_cur_ref: SE3, f_ref: torch.Tensor,
                             f_cur: torch.Tensor):
    """Depths (d_ref, d_cur, ok) of a ray pair by a 2x2 normal-equation
    solve of d_ref * (R f_ref) - d_cur * f_cur = -t; ok is False for
    near-parallel rays."""
    A0 = T_cur_ref.rotate(f_ref)
    A1 = -f_cur
    a = torch.sum(A0 * A0, dim=-1)
    b = torch.sum(A0 * A1, dim=-1)
    c = torch.sum(A1 * A1, dim=-1)
    rhs0 = -torch.sum(A0 * T_cur_ref.t, dim=-1)
    rhs1 = -torch.sum(A1 * T_cur_ref.t, dim=-1)
    det = a * c - b * b
    ok = torch.abs(det) > 1e-12
    det_safe = torch.where(ok, det, torch.ones_like(det))
    d_ref = (c * rhs0 - b * rhs1) / det_safe
    d_cur = (a * rhs1 - b * rhs0) / det_safe
    return d_ref, d_cur, ok


def triangulate_midpoint(T_w_ref: SE3, T_w_cur: SE3, f_ref: torch.Tensor,
                         f_cur: torch.Tensor):
    """World point of two bearing rays, the midpoint of their closest
    approach (the bootstrap's vk::triangulate, initialization.cpp:79-97).
    Returns (p_world, ok): ok needs both depths positive."""
    T_cur_ref = T_w_cur.inverse() * T_w_ref
    d_ref, d_cur, ok = depth_from_triangulation(T_cur_ref, f_ref, f_cur)
    p_w = 0.5 * (T_w_ref.apply(f_ref * d_ref[..., None])
                 + T_w_cur.apply(f_cur * d_cur[..., None]))
    return p_w, ok & (d_ref > 0) & (d_cur > 0)
