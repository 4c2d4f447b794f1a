"""TUM-format trajectory I/O.

Port of ``rpg_svo_tpu/io/trajectory.py`` (the reference's trace output,
BenchmarkNode::tracePose, svo_ros/src/benchmark_node.cpp:91-110): one line
per frame, ``timestamp tx ty tz qx qy qz qw``, as the TUM RGB-D tools read
it.  Host numpy; poses come in and go out as the port's SE3 of tensors.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from rpg_svo_tpu_torch.geometry.se3 import SE3, quat_to_rot, rot_to_quat


def write_tum(path: str, entries: List[Tuple[float, np.ndarray, np.ndarray]]):
    """entries: (timestamp, t (3,), q (4,) xyzw), the camera in the world."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, t, q in entries:
            f.write("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n"
                    % (ts, t[0], t[1], t[2], q[0], q[1], q[2], q[3]))


def pose_entry(timestamp: float, T_w_c: SE3):
    """A write_tum entry of a pose (reads it to the host)."""
    return (timestamp, T_w_c.t.detach().cpu().numpy(),
            rot_to_quat(T_w_c.R).detach().cpu().numpy())


def read_tum(path: str):
    """Returns (timestamps (N,), t (N, 3), q (N, 4) xyzw)."""
    ts, tt, qq = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.replace(",", " ").split()]
            if len(v) < 8:
                continue
            ts.append(v[0])
            tt.append(v[1:4])
            qq.append(v[4:8])
    return np.asarray(ts), np.asarray(tt), np.asarray(qq)


def tum_to_se3(t: np.ndarray, q: np.ndarray) -> SE3:
    """Batched TUM rows -> SE3 (T_w_c), float32 on the CPU."""
    q = torch.as_tensor(np.asarray(q, np.float32))
    return SE3(quat_to_rot(q), torch.as_tensor(np.asarray(t, np.float32)))
