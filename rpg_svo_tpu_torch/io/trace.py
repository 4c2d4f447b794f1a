"""Per-frame trace CSV with the reference's SVO_TRACE schema.

Port of ``rpg_svo_tpu/io/trace.py`` (vk::PerformanceMonitor as wired in
frame_handler_base.cpp:46-74): the same timer and log columns, in the same
order, so the reference's analysis scripts read the port's traces too.
"""

from __future__ import annotations

import csv
from typing import Dict, List

TIMERS = [
    "pyramid_creation", "sparse_img_align", "reproject", "reproject_kfs",
    "reproject_candidates", "feature_align", "pose_optimizer",
    "point_optimizer", "local_ba", "tot_time",
]
LOGS = [
    "timestamp", "img_align_n_tracked", "repr_n_mps",
    "repr_n_new_references", "sfba_thresh", "sfba_error_init",
    "sfba_error_final", "sfba_n_edges_final", "loba_n_erredges_init",
    "loba_n_erredges_fin", "loba_err_init", "loba_err_fin",
    "n_candidates", "dropout",
]


class TraceWriter:
    """Collects per-frame rows and writes <trace_dir>/<name>.csv."""

    def __init__(self, trace_dir: str, name: str = "svo"):
        self.path = f"{trace_dir}/{name}.csv"
        self.rows: List[Dict] = []

    def log_frame(self, info: Dict):
        """One row from a FrameHandler.add_image info dict."""
        row = {k: info.get(k, 0.0) for k in TIMERS + LOGS}
        row["timestamp"] = info.get("timestamp", 0.0)
        row["tot_time"] = info.get("proc_time", 0.0)
        row["dropout"] = 1.0 if info.get("result") == "failure" else 0.0
        row["n_candidates"] = info.get("n_seeds", 0)
        self.rows.append(row)

    def flush(self):
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=TIMERS + LOGS)
            w.writeheader()
            w.writerows(self.rows)
        return self.path
