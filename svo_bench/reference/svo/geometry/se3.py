"""SE(3) rigid transforms on torch tensors.

Port of ``rpg_svo_tpu/geometry/se3.py``: rotation matrix + translation, so
compose and apply are batched multiply-reduce ops; exp/log are closed-form
Rodrigues with Taylor fallbacks.  Twist ordering is (v, w), translation
first, as in the reference (svo/include/svo/frame.h:116-138).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


def _mm3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 matmul as broadcast-multiply-reduce (full float32)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _mv3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 matrix-vector product as broadcast-multiply-reduce."""
    return torch.sum(M * v[..., None, :], dim=-1)


def _hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def _vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


class SE3(NamedTuple):
    """Rigid transform; supports arbitrary leading batch dims."""
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32,
                 device="cpu") -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(
            *batch_shape, 3, 3).clone()
        t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
        return SE3(R, t)

    @staticmethod
    def exp(xi: torch.Tensor) -> "SE3":
        """Exponential map of twist xi = (v, w), (..., 6) -> SE3."""
        v, w = xi[..., :3], xi[..., 3:]
        theta2 = torch.sum(w * w, dim=-1)
        theta = torch.sqrt(torch.clamp(theta2, min=0.0))
        W = _hat(w)
        W2 = _mm3(W, W)
        small = theta2 < _EPS
        one = torch.ones_like(theta)
        st = torch.where(small, 1.0 - theta2 / 6.0,
                         torch.sin(theta) / torch.where(small, one, theta))
        ct = torch.where(small, 0.5 - theta2 / 24.0,
                         (1.0 - torch.cos(theta))
                         / torch.where(small, one, theta2))
        vt = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                         (theta - torch.sin(theta))
                         / torch.where(small, one, theta2 * theta))
        eye = _eye3(xi, W.shape)
        R = eye + st[..., None, None] * W + ct[..., None, None] * W2
        V = eye + ct[..., None, None] * W + vt[..., None, None] * W2
        return SE3(R, _mv3(V, v))

    def log(self) -> torch.Tensor:
        """Logarithm map -> twist (..., 6) = (v, w)."""
        R, t = self.R, self.t
        trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
        cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
        theta = torch.arccos(cos_theta)
        theta2 = theta * theta
        small = theta < 1e-4
        one = torch.ones_like(theta)
        factor = torch.where(
            small, 0.5 + theta2 / 12.0,
            theta / (2.0 * torch.sin(torch.where(small, one, theta))))
        w = factor[..., None] * _vee(R - R.transpose(-1, -2))
        W = _hat(w)
        W2 = _mm3(W, W)
        denom = 2.0 * (1.0 - torch.cos(theta))
        coef = torch.where(
            small, 1.0 / 12.0 + theta2 / 720.0,
            (1.0 - theta * torch.sin(torch.where(small, one, theta))
             / torch.where(small, one, denom))
            / torch.where(small, one, theta2))
        Vinv = _eye3(t, W.shape) - 0.5 * W + coef[..., None, None] * W2
        return torch.cat([_mv3(Vinv, t), w], dim=-1)

    def __mul__(self, other: "SE3") -> "SE3":
        return SE3(_mm3(self.R, other.R), _mv3(self.R, other.t) + self.t)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_mv3(Rt, self.t))

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        """Transform points p (..., 3)."""
        return _mv3(self.R, p) + self.t

    def rotate(self, p: torch.Tensor) -> torch.Tensor:
        return _mv3(self.R, p)

    def adjoint(self) -> torch.Tensor:
        """Adjoint matrix (..., 6, 6) in (v, w) twist ordering."""
        tR = _mm3(_hat(self.t), self.R)
        top = torch.cat([self.R, tR], dim=-1)
        bot = torch.cat([torch.zeros_like(self.R), self.R], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def matrix(self) -> torch.Tensor:
        """Homogeneous 4x4 matrix (..., 4, 4)."""
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype,
                              device=self.t.device).expand(
                                  *self.t.shape[:-1], 1, 4)
        top = torch.cat([self.R, self.t[..., None]], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    @staticmethod
    def from_matrix(M: torch.Tensor) -> "SE3":
        return SE3(M[..., :3, :3], M[..., :3, 3])

    def normalize(self) -> "SE3":
        """Re-orthonormalize R by Gram-Schmidt (drift control)."""
        r0 = self.R[..., 0, :]
        r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
        r1 = self.R[..., 1, :]
        r1 = r1 - torch.sum(r0 * r1, dim=-1, keepdim=True) * r0
        r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
        r2 = torch.linalg.cross(r0, r1, dim=-1)
        return SE3(torch.stack([r0, r1, r2], dim=-2), self.t)

    def where(self, cond: torch.Tensor, other: "SE3") -> "SE3":
        """Elementwise select: self where cond, else other (scalar cond)."""
        return SE3(torch.where(cond, self.R, other.R),
                   torch.where(cond, self.t, other.t))


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    return _hat(w)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (x, y, z, w) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.clamp(n, min=1e-12),
                    torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (x, y, z, w), branch-free: the
    four candidate constructions, the one with the largest pivot kept."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 0.5
    qw0 = half_sqrt(1.0 + tr)
    q0 = torch.stack([(m21 - m12), (m02 - m20), (m10 - m01),
                      4.0 * qw0 * qw0], dim=-1) / (4.0 * qw0[..., None])
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([4.0 * qx1 * qx1, (m01 + m10), (m02 + m20),
                      (m21 - m12)], dim=-1) / (4.0 * qx1[..., None])
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m01 + m10), 4.0 * qy2 * qy2, (m12 + m21),
                      (m02 - m20)], dim=-1) / (4.0 * qy2[..., None])
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m02 + m20), (m12 + m21), 4.0 * qz3 * qz3,
                      (m10 - m01)], dim=-1) / (4.0 * qz3[..., None])
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
