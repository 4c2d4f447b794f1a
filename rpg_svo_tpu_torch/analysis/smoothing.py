"""Ground-truth smoothing and dataset statistics.

A copy of ``rpg_svo_tpu/analysis/smoothing.py`` (numpy and scipy).
Equivalents of the reference's svo_analysis helpers:
- filter_groundtruth_smooth.py — zero-phase Butterworth low-pass of mocap
  orientation (quaternions -> rpy -> filtfilt -> quaternions);
- analyse_dataset.py — trajectory length / height / duration / speed
  statistics of a ground-truth file.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy import signal


def _quat_to_rpy(q: np.ndarray) -> np.ndarray:
    """(N, 4) xyzw -> (N, 3) roll/pitch/yaw (sxyz convention)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


def _rpy_to_quat(rpy: np.ndarray) -> np.ndarray:
    """(N, 3) -> (N, 4) xyzw."""
    r, p, y = rpy[:, 0] / 2, rpy[:, 1] / 2, rpy[:, 2] / 2
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], axis=-1)


def smooth_orientation(q: np.ndarray, f_sensor: float = 200.0,
                       f_cut: float = 15.0, order: int = 5) -> np.ndarray:
    """Zero-phase Butterworth low-pass on orientation, through rpy —
    the reference's mocap de-noising (filter_groundtruth_smooth.py)."""
    rpy = np.unwrap(_quat_to_rpy(np.asarray(q, float)), axis=0)
    b, a = signal.butter(order, f_cut / (f_sensor / 2.0))
    filt = np.stack([signal.filtfilt(b, a, rpy[:, i]) for i in range(3)],
                    axis=-1)
    return _rpy_to_quat(filt)


def smooth_groundtruth(data: np.ndarray, f_sensor: float = 200.0,
                       f_cut: float = 15.0) -> np.ndarray:
    """data (N, 8): timestamp, tx, ty, tz, qx, qy, qz, qw (TUM format).
    Returns the same with smoothed orientation."""
    out = np.array(data, float, copy=True)
    out[:, 4:8] = smooth_orientation(data[:, 4:8], f_sensor, f_cut)
    return out


def dataset_stats(data: np.ndarray, stepsize: int = 10) -> Dict[str, float]:
    """Trajectory statistics of a TUM ground-truth array (N, >=4):
    timestamp, tx, ty, tz, ... (analyse_dataset.py semantics)."""
    data = np.asarray(data, float)
    steps = np.arange(0, data.shape[0], stepsize)
    pos = data[steps, 1:4]
    length = float(np.sum(np.linalg.norm(np.diff(pos, axis=0), axis=1)))
    duration = float(data[-1, 0] - data[0, 0])
    return {
        "trajectory_length_m": length,
        "height_mean_m": float(np.mean(data[:, 3])),
        "height_median_m": float(np.median(data[:, 3])),
        "height_std_m": float(np.std(data[:, 3])),
        "duration_s": duration,
        "speed_m_per_s": length / max(duration, 1e-9),
    }
