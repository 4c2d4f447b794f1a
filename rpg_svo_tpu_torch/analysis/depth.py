"""Depth-error precision analysis.

A copy of ``rpg_svo_tpu/analysis/depth.py`` (svo_analysis
analyse_depth.py:24-55): summary statistics of per-feature depth errors
(the reference's golden percentiles, svo/test/test_depth_filter.cpp:
143-155) and the precision curve, the fraction of errors below a swept
threshold.  numpy only.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def depth_error_stats(errors: np.ndarray) -> Dict[str, float]:
    """Mean and the reference's golden percentiles (p50/p80/p95)."""
    e = np.abs(np.asarray(errors, dtype=np.float64))
    if e.size == 0:
        return {"n": 0, "mean": float("nan"), "p50": float("nan"),
                "p80": float("nan"), "p95": float("nan")}
    return {
        "n": int(e.size),
        "mean": float(np.mean(e)),
        "p50": float(np.percentile(e, 50)),
        "p80": float(np.percentile(e, 80)),
        "p95": float(np.percentile(e, 95)),
    }


def precision_curve(errors: np.ndarray,
                    thresholds: Optional[Sequence[float]] = None):
    """Fraction of |errors| <= t for each threshold t: (thresholds (T,),
    fraction (T,)).  The default thresholds sweep 0..p99 in 100 steps."""
    e = np.abs(np.asarray(errors, dtype=np.float64))
    if thresholds is None:
        hi = np.percentile(e, 99) if e.size else 1.0
        thresholds = np.linspace(0.0, max(hi, 1e-12), 100)
    thresholds = np.asarray(thresholds, dtype=np.float64)
    if e.size == 0:
        return thresholds, np.zeros_like(thresholds)
    return thresholds, np.mean(e[None, :] <= thresholds[:, None], axis=1)


def load_depth_trace(path: str) -> np.ndarray:
    """Read a depth-error tracefile (one error per line, or ts err...)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            rows.extend(float(v) for v in (vals[1:] if len(vals) > 1
                                           else vals))
    return np.asarray(rows, dtype=np.float64)
