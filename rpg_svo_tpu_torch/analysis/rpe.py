"""Relative pose error (RPE).

A copy of ``rpg_svo_tpu/analysis/rpe.py`` (the TUM tool the reference
vendors, svo_analysis/.../evaluate_rpe.py): the error of the relative
motion over a fixed frame delta, translational and rotational.  numpy only.
"""

from __future__ import annotations

import numpy as np


def _to_mat(t: np.ndarray, R: np.ndarray) -> np.ndarray:
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = t
    return M


def rpe(gt_t: np.ndarray, gt_R: np.ndarray, est_t: np.ndarray,
        est_R: np.ndarray, delta: int = 1) -> dict:
    """Relative pose error over `delta` frames.

    gt_t/est_t (N, 3); gt_R/est_R (N, 3, 3), as T_w_c.  Returns
    translational (m) and rotational (rad) statistics.  float64
    throughout, and the angle from the skew part with atan2: arccos of the
    trace is ill-conditioned near zero."""
    n = gt_t.shape[0]
    gt_t = np.asarray(gt_t, np.float64)
    gt_R = np.asarray(gt_R, np.float64)
    est_t = np.asarray(est_t, np.float64)
    est_R = np.asarray(est_R, np.float64)
    terrs, rerrs = [], []
    for i in range(n - delta):
        j = i + delta
        G = np.linalg.inv(_to_mat(gt_t[i], gt_R[i])) \
            @ _to_mat(gt_t[j], gt_R[j])
        E = np.linalg.inv(_to_mat(est_t[i], est_R[i])) \
            @ _to_mat(est_t[j], est_R[j])
        D = np.linalg.inv(G) @ E
        terrs.append(np.linalg.norm(D[:3, 3]))
        Rd = D[:3, :3]
        skew = 0.5 * np.array([Rd[2, 1] - Rd[1, 2], Rd[0, 2] - Rd[2, 0],
                               Rd[1, 0] - Rd[0, 1]])
        rerrs.append(np.arctan2(np.linalg.norm(skew),
                                0.5 * (np.trace(Rd) - 1.0)))
    terrs = np.asarray(terrs)
    rerrs = np.asarray(rerrs)
    return {
        "trans_rmse": float(np.sqrt((terrs ** 2).mean())),
        "trans_median": float(np.median(terrs)),
        "rot_rmse": float(np.sqrt((rerrs ** 2).mean())),
        "rot_median": float(np.median(rerrs)),
        "n": int(terrs.shape[0]),
    }
