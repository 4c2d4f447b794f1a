"""Homography estimation (RANSAC and DLT) and its decomposition.

Port of ``rpg_svo_tpu/ops/homography.py`` (vikit's Homography as the
reference bootstrap uses it, svo/src/initialization.cpp:171-195): all
RANSAC hypotheses are solved at once (S DLT systems, each through the
eigenvector of its 9x9 normal matrix), all points are scored against all
hypotheses in one (S, N) pass, the best consensus set is refitted, and the
refit homography is decomposed into 8 (R, t) hypotheses scored by positive
triangulated depths.

The minimal samples come from ``ransac_draw``, a function of their own
drawing from an explicit ``torch.Generator`` (the JAX package draws with
``jax.random.categorical``, whose stream torch cannot reproduce).  The
eigenvector's sign is arbitrary and differs between LAPACK builds and
cuSOLVER, so H may come out as -H; the transfer error and the
decomposition do not depend on it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.geometry.triangulation import depth_from_triangulation


def _dlt_rows(uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """DLT constraint rows of point pairs: (..., N, 2, 9)."""
    x, y = uv1[..., 0], uv1[..., 1]
    xp, yp = uv2[..., 0], uv2[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, x * xp, y * xp, xp],
                     dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, x * yp, y * yp, yp],
                     dim=-1)
    return torch.stack([r1, r2], dim=-2)


def _solve_h(uv1: torch.Tensor, uv2: torch.Tensor,
             w: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares homography of correspondences (..., N, 2) pairs,
    optionally weighted per pair: (..., 3, 3) with unit Frobenius norm."""
    rows = _dlt_rows(uv1, uv2)
    A = rows.reshape(rows.shape[:-3] + (-1, 9))
    if w is not None:
        A = A * torch.repeat_interleave(w, 2, dim=-1)[..., None]
    M = A.transpose(-1, -2) @ A
    # eigenvalues ascend: the first eigenvector spans the null space
    h = torch.linalg.eigh(M)[1][..., 0]
    H = h.reshape(h.shape[:-1] + (3, 3))
    return H / torch.linalg.vector_norm(H, dim=(-2, -1), keepdim=True)


def _transfer_error(H: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """One-way transfer error |H uv1 - uv2| on the unit plane (..., N)."""
    p = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    q = torch.einsum("...ij,...nj->...ni", H, p)
    z = torch.where(torch.abs(q[..., 2:3]) < 1e-12,
                    torch.full_like(q[..., 2:3], 1e-12), q[..., 2:3])
    return torch.linalg.vector_norm(q[..., :2] / z - uv2, dim=-1)


class HomographyResult(NamedTuple):
    H: torch.Tensor            # (3, 3)
    inliers: torch.Tensor      # (N,)
    n_inliers: torch.Tensor    # int64
    T_cur_ref: SE3             # the selected decomposition
    decomp_ok: torch.Tensor    # bool


def ransac_draw(valid: torch.Tensor, n_ransac: int,
                generator: torch.Generator) -> torch.Tensor:
    """(n_ransac, 4) int64 indices drawn uniformly, with replacement, among
    the set entries of ``valid`` (the JAX package's categorical draw over
    the mask).  ``generator`` is a CPU generator, so a card and the CPU
    draw the same samples; the uniforms are moved to valid's device."""
    u = torch.rand((n_ransac, 4), generator=generator).to(valid.device)
    cs = torch.cumsum(valid.to(torch.int64), 0)
    n = cs[-1]
    k = torch.minimum((u * n).to(torch.int64), torch.clamp(n - 1, min=0))
    # the k-th set entry: the first position where the count reaches k + 1
    return torch.clamp(torch.searchsorted(cs, k + 1), max=valid.shape[0] - 1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def estimate_homography(uv_ref: torch.Tensor, uv_cur: torch.Tensor,
                        valid: torch.Tensor, idx: torch.Tensor,
                        thresh: float) -> HomographyResult:
    """RANSAC homography of unit-plane correspondences over the minimal
    samples ``idx`` (S, 4) (from ``ransac_draw``), the refit on the best
    consensus set and its decomposition.  thresh: the inlier threshold on
    the unit plane (reprojection threshold / focal length)."""
    Hs = _solve_h(uv_ref[idx], uv_cur[idx])                    # (S, 3, 3)
    err = _transfer_error(Hs, uv_ref[None], uv_cur[None])      # (S, N)
    inl = (err < thresh) & valid[None]
    best = torch.argmax(torch.sum(inl, dim=-1))
    w = inl.index_select(0, best.reshape(1))[0].to(torch.float32)
    H = _solve_h(uv_ref, uv_cur, w)
    inliers = (_transfer_error(H, uv_ref, uv_cur) < thresh) & valid
    one = torch.ones_like(uv_ref[:, :1])
    T, ok = decompose_homography(H, _unit(torch.cat([uv_ref, one], -1)),
                                 _unit(torch.cat([uv_cur, one], -1)),
                                 inliers)
    return HomographyResult(H, inliers, torch.sum(inliers), T, ok)


def decompose_homography(H: torch.Tensor, f_ref: torch.Tensor,
                         f_cur: torch.Tensor, inliers: torch.Tensor):
    """Faugeras-Lustman decomposition of a unit-plane homography into 8
    (R, t) hypotheses, scored by the inlier correspondences triangulated
    with positive depth in both views; the first best wins.  Returns
    (T_cur_ref with |t| = 1, ok: the best scores above 70% of the
    inliers).  float32 throughout, as in JAX: a float64 SVD would change
    the winner on near-ties."""
    dev = H.device
    U, S, Vt = torch.linalg.svd(H)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    safe = torch.clamp(d2, min=1e-12)
    d1n, d3n = d1 / safe, d3 / safe
    denom = torch.clamp(d1n * d1n - d3n * d3n, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1n * d1n - 1.0) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((1.0 - d3n * d3n) / denom, min=0.0))
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)

    def unit2(sn, cs):
        nrm = torch.sqrt(torch.clamp(sn * sn + cs * cs, min=1e-12))
        return sn / nrm, cs / nrm

    Rs, ts = [], []
    # d' = +d2: R' rotates about y by theta
    sin_t, cos_t = unit2((d1n - d3n) * x1 * x3,
                         torch.clamp(d1n * x3 * x3 + d3n * x1 * x1, -1.0, 1.0))
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = torch.stack([torch.stack([cos_t, zero, -st]),
                              torch.stack([zero, one, zero]),
                              torch.stack([st, zero, cos_t])])
            tp = (d1n - d3n) * torch.stack([e1 * x1, zero, -e3 * x3])
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ tp)
    # d' = -d2: R' is a reflection about y by phi
    sin_p, cos_p = unit2((d1n + d3n) * x1 * x3,
                         torch.clamp(d3n * x1 * x1 - d1n * x3 * x3, -1.0, 1.0))
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * sin_p
            Rp = torch.stack([torch.stack([cos_p, zero, sp]),
                              torch.stack([zero, -one, zero]),
                              torch.stack([sp, zero, -cos_p])])
            tp = (d1n + d3n) * torch.stack([e1 * x1, zero, e3 * x3])
            Rs.append(-s * U @ Rp @ Vt)
            ts.append(U @ tp)
    Rs = torch.stack(Rs)                                     # (8, 3, 3)
    ts = torch.stack(ts)
    ts = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    d_ref, d_cur, tri_ok = depth_from_triangulation(
        SE3(Rs[:, None], ts[:, None]), f_ref[None], f_cur[None])
    scores = torch.sum(inliers & tri_ok & (d_ref > 0) & (d_cur > 0), dim=-1)
    best = torch.argmax(scores)
    pick = lambda a: a.index_select(0, best.reshape(1))[0]  # noqa: E731
    ok = pick(scores) > 0.7 * torch.clamp(torch.sum(inliers), min=1)
    return SE3(pick(Rs), pick(ts)), ok
