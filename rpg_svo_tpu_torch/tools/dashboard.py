"""Graphical VO dashboard — the rqt_svo widget equivalent.

Port of ``rpg_svo_tpu/tools/dashboard.py`` (host code: numpy, and
matplotlib inside ``render_dashboard``).

The reference GUI (rqt_svo/src/rqt_svo/svo_widget.py:85-107) shows an
info label (fps, #features, stage, tracking quality), a tracked-features
progress bar, and start/reset/quit buttons that publish remote keys.
This renders the same content headlessly from the trace stream the
pipeline already writes (io/trace.py — the SVO_TRACE schema the
reference's PerformanceMonitor emits):

- status banner: fps / #features / stage / tracking quality;
- tracked-features bar (num_tracked_bar equivalent);
- history panels: fps, #matches, per-frame processing time;
- dropouts marked on the timeline.

Offline:  python -m rpg_svo_tpu_torch.tools.dashboard /tmp/svo.csv -o dash.png
Live:     ... --live     (re-reads the growing CSV and re-renders, the
          rqt update loop; remote keys go to tools/live.py's stdin).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

# stage names: tools/live.py drives FrameHandler, whose stages mirror
# the reference's FrameHandlerBase::Stage (frame_handler_base.h:41-46)
_STAGES = {0: "PAUSED", 1: "FIRST_FRAME", 2: "SECOND_FRAME",
           3: "RUNNING", 4: "RELOCALIZING"}


def _quality(n_matches: float, min_fts: int = 50) -> str:
    if n_matches <= 0:
        return "CRITICAL"
    if n_matches < min_fts:
        return "BAD TRACKING"
    return "GOOD TRACKING"


def render_dashboard(trace: dict, out_path: str, max_fts: int = 120,
                     stage: int = 3) -> str:
    """Render the dashboard PNG from a loaded trace (analysis.timing.
    load_trace dict).  Returns out_path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tot = trace.get("tot_time", np.zeros((0,)))
    n = len(tot)
    ts = trace.get("timestamp", np.arange(n, dtype=float))
    matches = trace.get("repr_n_new_references", np.zeros(n))
    dropout = trace.get("dropout", np.zeros(n))
    fps = np.where(tot > 0, 1.0 / np.maximum(tot, 1e-9), 0.0)

    fig = plt.figure(figsize=(9, 6))
    grid = fig.add_gridspec(4, 2, height_ratios=[0.7, 0.5, 2, 2],
                            hspace=0.65, wspace=0.25)

    # --- info label (svo_widget.py:81-105) ---
    ax = fig.add_subplot(grid[0, :])
    ax.axis("off")
    if n:
        cur_fps = fps[-1]
        cur_m = int(matches[-1])
        st = int(dropout[-1]) and 4 or stage
        txt = (f"fps = {cur_fps:.2f}    #Features = {cur_m}    "
               f"{_STAGES.get(st, '?')}    {_quality(cur_m)}")
    else:
        txt = "Not Connected"
    ax.text(0.01, 0.5, txt, fontsize=13, family="monospace", va="center")

    # --- tracked-features progress bar (num_tracked_bar) ---
    ax = fig.add_subplot(grid[1, :])
    ax.barh([0], [matches[-1] if n else 0], color="#2a9d2a", height=0.6)
    ax.set_xlim(0, max_fts)
    ax.set_yticks([])
    ax.set_xlabel("tracked features", fontsize=8)

    # --- history panels ---
    ax = fig.add_subplot(grid[2, 0])
    ax.plot(ts[:n], fps, "g-", lw=0.8)
    ax.set_title("fps", fontsize=9)
    ax = fig.add_subplot(grid[2, 1])
    ax.plot(ts[:n], matches, "b-", lw=0.8)
    ax.axhline(50, color="r", ls="--", lw=0.6)
    ax.set_title("#matches (quality gate dashed)", fontsize=9)
    ax = fig.add_subplot(grid[3, 0])
    ax.plot(ts[:n], tot * 1e3, "k-", lw=0.8)
    ax.set_title("processing time [ms]", fontsize=9)
    ax.set_xlabel("time [s]", fontsize=8)
    ax = fig.add_subplot(grid[3, 1])
    drops = np.flatnonzero(dropout > 0)
    ax.vlines(ts[drops] if n else [], 0, 1, colors="r")
    ax.set_ylim(0, 1)
    ax.set_yticks([])
    ax.set_title(f"dropouts ({len(drops)})", fontsize=9)
    ax.set_xlabel("time [s]", fontsize=8)
    if n:
        ax.set_xlim(ts[0], max(ts[n - 1], ts[0] + 1e-3))

    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None):
    from rpg_svo_tpu_torch.analysis.timing import load_trace

    ap = argparse.ArgumentParser(description="rqt_svo-style dashboard")
    ap.add_argument("trace", help="trace CSV (io/trace.py schema)")
    ap.add_argument("-o", "--out", default="dashboard.png")
    ap.add_argument("--live", action="store_true",
                    help="re-read the trace and re-render periodically")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--max-fts", type=int, default=120)
    args = ap.parse_args(argv)

    while True:
        if os.path.exists(args.trace):
            render_dashboard(load_trace(args.trace), args.out,
                             max_fts=args.max_fts)
            print(f"rendered {args.out}", flush=True)
        if not args.live:
            break
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
