"""Batched pyramidal Lucas-Kanade optical flow.

Port of ``rpg_svo_tpu/ops/lk.py`` (OpenCV's calcOpticalFlowPyrLK as the
reference bootstrap uses it, svo/src/initialization.cpp:127-169): all
corners track at once, coarse to fine with the flow carried across levels,
on (2 halfwin + 1)^2 windows whose out-of-image samples are masked pixel
by pixel; the model has an illumination offset.  Each level runs
``n_iter`` masked Gauss-Newton iterations: a corner stops updating once
its step falls below 0.03 px.
"""

from __future__ import annotations

from typing import Tuple

import torch

from svo_bench.reference.svo.core import graphed
from svo_bench.reference.svo.geometry.linalg import inv3x3
from svo_bench.reference.svo.ops.interp import bilinear


@graphed.jit(static_argnames=("halfwin", "n_iter", "max_level"))
def track_klt(ref_pyr: Tuple[torch.Tensor, ...],
              cur_pyr: Tuple[torch.Tensor, ...],
              px_ref: torch.Tensor, valid: torch.Tensor, halfwin: int = 15,
              n_iter: int = 20, max_level: int = 4):
    """Track level-0 corners px_ref (N, 2) from ref to cur.  Returns
    (px_cur (N, 2), ok (N,)): ok when the corner converged at level 0 and
    landed inside the image."""
    dev = px_ref.device
    r = torch.arange(2 * halfwin + 1, dtype=torch.float32, device=dev) \
        - halfwin
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)   # (W2, 2)
    W2 = grid.shape[0]
    N = px_ref.shape[0]
    eye3 = torch.eye(3, device=dev)
    ex, ey = eye3[0, :2], eye3[1, :2]

    flow = torch.zeros_like(px_ref)          # in level-0 pixels
    conv = torch.zeros_like(valid)
    for level in range(max_level, -1, -1):
        scale = 1.0 / (2.0 ** level)
        ref_img, cur_img = ref_pyr[level], cur_pyr[level]
        p_ref = px_ref * scale
        coords = p_ref[:, None, :] + grid[None]
        ref_patch, m_ref = bilinear(ref_img, coords)
        rp1, m1 = bilinear(ref_img, coords + ex)
        rm1, m2 = bilinear(ref_img, coords - ex)
        rp2, m3 = bilinear(ref_img, coords + ey)
        rm2, m4 = bilinear(ref_img, coords - ey)
        m_ref = m_ref & m1 & m2 & m3 & m4                     # (N, W2)
        dx = 0.5 * (rp1 - rm1)
        dy = 0.5 * (rp2 - rm2)
        J = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)  # (N, W2, 3)
        Jm = J * m_ref[..., None]
        H = torch.einsum("npj,npk->njk", Jm, J)
        # closed form: a batched library inverse may run host-side
        # (MAGMA) or read back its info, which a CUDA graph cannot hold
        Hinv = inv3x3(H + 1e-4 * eye3)
        n_ref = torch.sum(m_ref, dim=-1)
        lvl_ok = valid & (n_ref > 0.25 * W2)

        d = flow
        mu = torch.zeros((N,), device=dev)
        conv = torch.zeros_like(valid)
        for _ in range(n_iter):
            cc = (p_ref + d * scale)[:, None, :] + grid[None]
            cur, m_cur = bilinear(cur_img, cc)
            m = m_ref & m_cur
            frac = torch.sum(m, dim=-1) / torch.clamp(n_ref, min=1)
            good = lvl_ok & (frac > 0.5) & ~conv
            res = torch.where(m, cur - ref_patch + mu[:, None],
                              torch.zeros_like(cur))
            upd = torch.einsum("njk,nk->nj", Hinv,
                               torch.einsum("np,npj->nj", res, J))
            d = torch.where(good[:, None], d - upd[:, :2] / scale, d)
            mu = torch.where(good, mu - upd[:, 2], mu)
            conv = conv | (good & (upd[:, 0] ** 2 + upd[:, 1] ** 2
                                   < 0.03 * 0.03))
            # with no corner updating, the remaining iterations repeat
            # this one: the CPU stops reading them (on the card the check
            # would be a host sync)
            if not good.is_cuda and not bool(torch.any(good)):
                break
        flow = d
    px_cur = px_ref + flow
    H0, W0 = cur_pyr[0].shape
    inb = (px_cur[:, 0] >= 0) & (px_cur[:, 0] < W0 - 1) \
        & (px_cur[:, 1] >= 0) & (px_cur[:, 1] < H0 - 1)
    return px_cur, valid & conv & inb
