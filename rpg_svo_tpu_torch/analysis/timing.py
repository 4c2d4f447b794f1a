"""Timing analysis of trace CSVs.

A copy of ``rpg_svo_tpu/analysis/timing.py`` reading the port's own
``io/trace.TIMERS``; matplotlib only inside ``plot_timing``.  Equivalent
of svo_analysis/analyse_timing.py (:27-69): per-stage timing statistics
from the trace.csv written by io.trace.TraceWriter (same column schema as
the reference's SVO_TRACE output).
"""

from __future__ import annotations

import csv
from typing import Dict, List

import numpy as np

from rpg_svo_tpu_torch.io.trace import TIMERS


def load_trace(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    out = {}
    if not rows:
        return out
    for k in rows[0].keys():
        try:
            out[k] = np.asarray([float(r[k]) for r in rows])
        except ValueError:
            pass
    return out


def timing_stats(trace: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """Per-stage mean/median/p90 in milliseconds."""
    stats = {}
    for k in TIMERS:
        if k not in trace or len(trace[k]) == 0:
            continue
        v = trace[k] * 1000.0
        stats[k] = {
            "mean_ms": float(v.mean()),
            "median_ms": float(np.median(v)),
            "p90_ms": float(np.percentile(v, 90)),
            "max_ms": float(v.max()),
        }
    return stats


def plot_timing(trace: Dict[str, np.ndarray], out_dir: str,
                prefix: str = "timing") -> List[str]:
    """Per-stage timing plots from a trace (svo_analysis/analyse_timing.py
    :16-69 output parity): <prefix>.pdf — total processing time over the
    sequence with its mean; <prefix>_boxplot.pdf — horizontal per-stage
    boxplots labelled with median ms; <prefix>_reprojection.pdf — the
    reprojection-stage breakdown.  Returns the written paths."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if "tot_time" not in trace or len(trace["tot_time"]) == 0:
        return []
    is_frame = np.flatnonzero(trace.get(
        "repr_n_mps", np.zeros_like(trace["tot_time"])) >= 0)
    ts = trace.get("timestamp", np.arange(len(trace["tot_time"]),
                                          dtype=float))
    ts = ts - ts[0] if len(ts) else ts
    written = []

    def col(k):
        return trace.get(k, np.zeros_like(trace["tot_time"]))[is_frame] * 1e3

    tot = col("tot_time")
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.set_ylabel("processing time [ms]")
    ax.set_xlabel("time [s]")
    ax.plot(ts[is_frame], tot, "g-", label="total time [ms]")
    ax.plot(ts[is_frame], np.full(len(is_frame), tot.mean()), "b--",
            label=f"{tot.mean():.1f}ms mean time")
    ax.legend()
    fig.tight_layout()
    p = os.path.join(out_dir, f"{prefix}.pdf")
    fig.savefig(p, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    def boxplot(path, rows):
        rows = [(lbl, v) for lbl, v in rows if len(v)]
        fig, ax = plt.subplots(figsize=(6, 2))
        ax.set_xlabel("Processing time [ms]")
        ax.boxplot([v for _, v in rows], sym="", vert=False)
        ax.set_yticks(np.arange(len(rows)) + 1)
        ax.set_yticklabels([lbl % np.median(v) for lbl, v in rows])
        fig.tight_layout()
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    boxplot(os.path.join(out_dir, f"{prefix}_boxplot.pdf"), [
        ("Total Motion Estimation: %2.2fms", tot),
        ("Refinement: %2.2fms", col("pose_optimizer")
         + col("point_optimizer")),
        ("Feature Alignment: %2.2fms", col("reproject")),
        ("Sparse Image Alignment: %2.2fms", col("sparse_img_align")),
        ("Pyramid Creation: %2.2fms", col("pyramid_creation")),
    ])
    boxplot(os.path.join(out_dir, f"{prefix}_reprojection.pdf"), [
        ("Total Reprojection: %2.2fms", col("reproject")),
        ("Feature Alignment: %2.2fms", col("feature_align")),
        ("Reproject Candidates: %2.2fms", col("reproject_candidates")),
        ("Reproject Keyframes: %2.2fms", col("reproject_kfs")),
    ])
    return written


def log_stats(trace: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """Tracking health metrics (analyse_logs.py equivalent)."""
    out = {}
    for k in ("img_align_n_tracked", "repr_n_mps",
              "repr_n_new_references", "sfba_n_edges_final",
              "sfba_error_final", "n_candidates"):
        if k in trace and len(trace[k]):
            v = trace[k]
            out[k] = {"mean": float(v.mean()),
                      "median": float(np.median(v)),
                      "min": float(v.min()), "max": float(v.max())}
    if "dropout" in trace and len(trace["dropout"]):
        out["n_dropouts"] = int(trace["dropout"].sum())
    return out
