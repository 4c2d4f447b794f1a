"""Multi-experiment comparison.

A copy of ``rpg_svo_tpu/analysis/compare.py``, so that the port imports
nothing of the JAX package.  Equivalent of the reference's comparison layer
(svo_analysis/scripts/compare_results.py + comparison.py, driven by
comparisons/*.yaml): load several experiment result directories (each
written by tools/benchmark.py: traj_estimate.txt, groundtruth.txt,
report.json, trace csv), compute aligned translation-error curves and
summary statistics per experiment, and optionally render comparison
plots.  numpy; matplotlib only inside the plotting functions.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from rpg_svo_tpu_torch.analysis.ate import (
    associate, align_umeyama,
)


def load_tum(path: str) -> np.ndarray:
    """TUM trajectory file -> (N, 8) array (skips comments)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split()])
    return np.asarray(rows, float)


def error_curve(est_path: str, gt_path: str, max_dt: float = 0.02,
                with_scale: bool = True) -> Dict[str, np.ndarray]:
    """Translation error per associated frame after Sim3 alignment, plus
    cumulative trajectory distance (the reference plots error over
    traveled distance)."""
    est = load_tum(est_path)
    gt = load_tum(gt_path)
    ia, ib = associate(gt[:, 0], est[:, 0], max_dt)
    p_gt = gt[ia, 1:4]
    p_es = est[ib, 1:4]
    s, R, t = align_umeyama(p_es, p_gt, with_scale)
    p_al = (s * (R @ p_es.T)).T + t
    err = np.linalg.norm(p_al - p_gt, axis=1)
    dist = np.concatenate(
        [[0.0], np.cumsum(np.linalg.norm(np.diff(p_gt, axis=0), axis=1))])
    return {"timestamp": gt[ia, 0], "distance": dist, "trans_error": err}


def compare_experiments(result_dirs: List[str],
                        labels: Optional[List[str]] = None,
                        gt_name: str = "groundtruth.txt",
                        est_name: str = "traj_estimate.txt") -> Dict:
    """Summary comparison across experiment directories."""
    labels = labels or [os.path.basename(d.rstrip("/")) for d in result_dirs]
    out = {}
    for d, lab in zip(result_dirs, labels):
        entry: Dict = {}
        gt = os.path.join(d, gt_name)
        est = os.path.join(d, est_name)
        if os.path.exists(gt) and os.path.exists(est):
            c = error_curve(est, gt)
            e = c["trans_error"]
            entry.update(
                trans_error_rmse=float(np.sqrt(np.mean(e ** 2))),
                trans_error_mean=float(np.mean(e)),
                trans_error_median=float(np.median(e)),
                trans_error_max=float(np.max(e)),
                distance_m=float(c["distance"][-1]),
                curve=c,
            )
        rep = os.path.join(d, "report.json")
        if os.path.exists(rep):
            with open(rep) as f:
                entry["report"] = json.load(f)
        out[lab] = entry
    return out


def plot_comparison(results: Dict, out_pdf: str):
    """Translation-error-over-distance comparison plot (compare_results.py
    figure), one line per experiment."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    for lab, entry in results.items():
        if "curve" not in entry:
            continue
        c = entry["curve"]
        ax.plot(c["distance"], c["trans_error"], label=lab, linewidth=1.2)
    ax.set_xlabel("distance traveled [m]")
    ax.set_ylabel("translation error [m]")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def plot_markers(markers_seq: List, out_pdf: str):
    """Top-down map/trajectory plot from a sequence of viz.Markers —
    the offline consumer of the rviz marker-set equivalent
    (svo_ros/src/visualizer.cpp:198-267): trajectory points, keyframe
    poses with viewing axes, and the LAST frame's live point cloud
    (deleted points drop out exactly as removeDeletedPts removes their
    markers)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    traj = np.stack([mk.cam_pos for mk in markers_seq])
    ax.plot(traj[:, 0], traj[:, 1], "-", linewidth=1.0, label="trajectory")
    last = markers_seq[-1]
    if last.point_pos.size:
        ax.scatter(last.point_pos[:, 0], last.point_pos[:, 1], s=1,
                   alpha=0.4, label=f"points ({len(last.point_ids)})")
    if last.kf_pos.size:
        ax.scatter(last.kf_pos[:, 0], last.kf_pos[:, 1], marker="s", s=20,
                   label=f"keyframes ({len(last.kf_ids)})")
        # camera viewing direction (z axis) per keyframe
        for p, Rwc in zip(last.kf_pos, last.kf_R_wc):
            z = Rwc[:, 2] * 0.05
            ax.plot([p[0], p[0] + z[0]], [p[1], p[1] + z[1]],
                    "k-", linewidth=0.5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
