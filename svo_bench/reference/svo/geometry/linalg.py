"""Closed-form small-matrix inverses and solves (batched).

Port of ``rpg_svo_tpu/geometry/linalg.py``.  All systems here are damped
(+eps*I) by the callers, so no pivoting.  ``solve6x6_spd`` keeps the
reference's rollback signal: an indefinite system gives NaN (the square
root of a negative pivot), which the Gauss-Newton loops test for.
"""

from __future__ import annotations

import torch


def det2x2(A: torch.Tensor) -> torch.Tensor:
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2x2(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    d = det2x2(A)
    d = torch.where(torch.abs(d) < eps, torch.full_like(d, eps), d)
    adj = torch.stack([
        torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
        torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
    ], dim=-2)
    return adj / d[..., None, None]


def inv3x3(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = -(d * i - f * g)
    C02 = d * h - e * g
    C10 = -(b * i - c * h)
    C11 = a * i - c * g
    C12 = -(a * h - b * g)
    C20 = b * f - c * e
    C21 = -(a * f - c * d)
    C22 = a * e - b * d
    det = a * C00 + b * C01 + c * C02
    det = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    adj = torch.stack([
        torch.stack([C00, C10, C20], dim=-1),
        torch.stack([C01, C11, C21], dim=-1),
        torch.stack([C02, C12, C22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(inv3x3(A) * b[..., None, :], dim=-1)


def solve2x2(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(inv2x2(A) * b[..., None, :], dim=-1)


def cholesky6x6(A: torch.Tensor) -> torch.Tensor:
    """Unrolled lower Cholesky factor of one (6, 6) SPD matrix; an
    indefinite matrix yields NaN (no pivoting, no error raised)."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[:, j]
        if j > 0:
            s = s - torch.sum(L[:, :j] * L[j, :j][None, :], dim=-1)
        d = torch.sqrt(s[j])
        col = torch.zeros_like(s)
        col[j] = d
        col[j + 1:] = s[j + 1:] / d
        L[:, j] = col
    return L


def solve6x6_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a damped-SPD 6x6 system by unrolled Cholesky.  NaN in the
    result marks an indefinite system (the GN rollback signal)."""
    L = cholesky6x6(A)
    n = b.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        y[i] = (b[i] - torch.sum(L[i, :i] * y[:i])) / L[i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[i] = (y[i] - torch.sum(L[i + 1:, i] * x[i + 1:])) / L[i, i]
    return x
