"""Hand-eye calibration between an estimated and a ground-truth trajectory.

A copy of ``rpg_svo_tpu/analysis/hand_eye.py`` (numpy only).  Equivalent
of the reference's mocap workflow
(svo_analysis/src/svo_analysis/hand_eye_calib.py + vikit_py
align_trajectory.hand_eye_calib): given time-associated pose pairs, solve
for the fixed transform (R, b) between the tracked marker/body frame and
the camera frame from pairs of relative motions (AX = XB), then report
the residual translation error used to filter inaccurate pairs.

All quaternions are (x, y, z, w), matching TUM trajectory files.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(4,) xyzw -> (3, 3) rotation matrix."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3, 3) -> (4,) xyzw."""
    w = 0.5 * np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12))
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return np.array([x, y, z, w])


def hand_eye_calib(q_gt: np.ndarray, q_es: np.ndarray,
                   p_gt: np.ndarray, p_es: np.ndarray,
                   pair_idx: np.ndarray, delta: int = 50
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Solve the hand-eye problem from sampled relative-motion pairs.

    q_gt/q_es (N, 4) xyzw, p_gt/p_es (N, 3); pair_idx indexes the start of
    each relative motion and `delta` its span (the reference samples
    random pairs the same way).  Returns (R, b): the rotation and
    translation taking estimate-frame vectors to ground-truth-frame
    vectors (Tsai-Lenz style: rotation from the quaternion linear system,
    translation from the stacked (A - I) b = R t_B - t_A least squares).
    """
    pair_idx = np.asarray(pair_idx, dtype=int)
    pair_idx = pair_idx[(pair_idx >= 0) & (pair_idx + delta < len(q_gt))]
    n = len(pair_idx)
    if n < 2:
        raise ValueError("need at least 2 motion pairs")

    # rotation: for each pair, relative rotations A (estimate) and B (gt)
    # must satisfy A R = R B; in quaternion form M(qa, qb) vec(q) = 0.
    M = np.zeros((4 * n, 4))
    As, Bs = [], []
    for k, i in enumerate(pair_idx):
        A1 = _quat_to_rot(q_es[i])
        A2 = _quat_to_rot(q_es[i + delta])
        B1 = _quat_to_rot(q_gt[i])
        B2 = _quat_to_rot(q_gt[i + delta])
        A = A1.T @ A2
        B = B1.T @ B2
        As.append((A, A1))
        Bs.append((B, B1))
        qa = _rot_to_quat(A)            # (x, y, z, w)
        qb = _rot_to_quat(B)
        # left/right quaternion product matrices acting on q = (x,y,z,w)
        av, aw = qa[:3], qa[3]
        bv, bw = qb[:3], qb[3]
        L = np.zeros((4, 4))
        L[:3, :3] = aw * np.eye(3) + _skew(av)
        L[:3, 3] = av
        L[3, :3] = -av
        L[3, 3] = aw
        Rm = np.zeros((4, 4))
        Rm[:3, :3] = bw * np.eye(3) - _skew(bv)
        Rm[:3, 3] = bv
        Rm[3, :3] = -bv
        Rm[3, 3] = bw
        M[4 * k: 4 * k + 4] = L - Rm
    _, _, Vt = np.linalg.svd(M)
    q = Vt[-1]
    R = _quat_to_rot(q)

    # translation: (A_k - I) b = R t_B_k - t_A_k
    C = np.zeros((3 * n, 3))
    d = np.zeros(3 * n)
    for k, i in enumerate(pair_idx):
        (A, A1) = As[k]
        (B, B1) = Bs[k]
        t_A = A1.T @ (p_es[i + delta] - p_es[i])
        t_B = B1.T @ (p_gt[i + delta] - p_gt[i])
        C[3 * k: 3 * k + 3] = A - np.eye(3)
        d[3 * k: 3 * k + 3] = R @ t_B - t_A
    b, *_ = np.linalg.lstsq(C, d, rcond=None)
    return R, b


def hand_eye_residuals(q_gt: np.ndarray, q_es: np.ndarray,
                       p_gt: np.ndarray, p_es: np.ndarray,
                       R: np.ndarray, b: np.ndarray,
                       delta: int = 50) -> np.ndarray:
    """Per-pair relative-translation error under the calibration (the
    quantity the reference thresholds at its 90th percentile to reject
    inaccurate mocap segments)."""
    n = len(q_es) - delta
    err = np.zeros(n)
    for i in range(n):
        A1 = _quat_to_rot(q_es[i])
        A2 = _quat_to_rot(q_es[i + delta])
        B1 = _quat_to_rot(q_gt[i])
        A = A1.T @ A2
        t_A = A1.T @ (p_es[i + delta] - p_es[i])
        t_B = B1.T @ (p_gt[i + delta] - p_gt[i])
        t_es = R.T @ (A @ b + t_A - b)
        err[i] = np.linalg.norm(t_B - t_es)
    return err
