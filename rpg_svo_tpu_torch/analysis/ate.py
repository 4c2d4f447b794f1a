"""Absolute trajectory error (ATE) with Umeyama alignment.

A copy of ``rpg_svo_tpu/analysis/ate.py`` (the TUM benchmark tool the
reference vendors, svo_analysis/src/svo_analysis/tum_benchmark_tools/
evaluate_ate.py), so that the port imports nothing of the JAX package:
associate timestamps, align the estimated trajectory to ground truth with
a closed-form similarity (with scale for a monocular map) and report the
translational error.  numpy only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_dt: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (tum associate.py semantics).
    Returns index arrays (ia, ib)."""
    ia, ib = [], []
    used_b = set()
    for i in np.argsort(ts_a):
        j = int(np.argmin(np.abs(ts_b - ts_a[i])))
        if abs(ts_b[j] - ts_a[i]) <= max_dt and j not in used_b:
            ia.append(i)
            ib.append(j)
            used_b.add(j)
    return np.asarray(ia, dtype=int), np.asarray(ib, dtype=int)


def align_umeyama(model: np.ndarray, data: np.ndarray,
                  with_scale: bool = True):
    """Least-squares similarity aligning model -> data, both (N, 3).
    Returns (s, R, t) with data ~= s * R @ model + t."""
    mu_m = model.mean(axis=0)
    mu_d = data.mean(axis=0)
    mc = model - mu_m
    dc = data - mu_d
    Sigma = dc.T @ mc / model.shape[0]
    U, D, Vt = np.linalg.svd(Sigma)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_m = (mc ** 2).sum() / model.shape[0]
    s = (D * np.diag(S)).sum() / max(var_m, 1e-12) if with_scale else 1.0
    t = mu_d - s * R @ mu_m
    return s, R, t


def ate_rmse(gt_pos: np.ndarray, est_pos: np.ndarray,
             with_scale: bool = True) -> dict:
    """Align est -> gt and report translational error stats (meters)."""
    s, R, t = align_umeyama(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = np.linalg.norm(aligned - gt_pos, axis=-1)
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "scale": float(s),
        "n": int(err.shape[0]),
    }
