"""The comparison that decides ``correct``: the program's pose and map
after a frame against the plain reference's from the same state and
image.

Four numbers compared, the first three the worst over the run's
samples (and streams), and two logged:

- ``pose_gap_m``: the camera's position gap, or the rotation gap (largest
  entry of the rotation matrices' difference) times the scene depth
  (``DEPTH_M``), whichever is larger;
- ``map_gap_m``: the same over the keyframes both maps hold, and the
  position gap of every point both maps hold;
- ``kf_mismatch``: keyframe slots that the two maps hold differently (a
  keyframe inserted or deleted on one side only), where the program and
  the reference made the same keyframe decision (an exact comparison;
  where a pose within ``pose_gap_m`` of the other falls on the other side
  of the keyframe rule's threshold, the decisions differ, and the
  sample's ``kf_flip`` is logged instead);
- ``gt_jump_m``: the largest change of a frame's position error against
  the ground truth from one frame of a stream to the next, over the
  window's chain of frames (every stream), which judges each hand-over
  of the state along the chain;
- ``gt_gap_m`` (logged): the largest position error itself, which the
  low-precision control does not separate from sound runs (PERF.md);
- ``map_mismatch``: what the two maps hold differently: keyframe slots,
  the types of points that existed before the step, points born in the
  step that pair with none of the other side's, seeds that existed
  before and are live on one side only, and the difference in seeds born
  (a keyframe inserted or not, a point added, deleted or promoted, a seed
  born, converged or dropped).

Limits per cell live in ``limits/<cell>.json``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# the scene's depth below the camera (the paths' height): a rotation gap
# moves a point there by about this many metres per radian
DEPTH_M = 1.5
# the numbers compared with a limit; ``map_mismatch`` and ``gt_gap_m`` are
# read and logged but not compared: the low-precision control gives
# neither a reading three times the sound runs' (PERF.md), so neither has
# an upper reading to set a limit below
NUMBERS = ("pose_gap_m", "map_gap_m", "kf_mismatch", "gt_jump_m")


def _max(*values: float) -> float:
    """The largest value; a NaN reads as infinitely far."""
    return max(math.inf if math.isnan(v) else v for v in values)


def _positions(R_fw: torch.Tensor, t_fw: torch.Tensor) -> torch.Tensor:
    return -(R_fw.transpose(-1, -2) * t_fw[..., None, :]).sum(-1)


def pose_gap(R_a, t_a, R_b, t_b) -> float:
    """Gap of two poses T_w_c given as (R_wc, t_wc), in metres."""
    R_a, t_a, R_b, t_b = (torch.as_tensor(x, dtype=torch.float64,
                                          device="cpu")
                          for x in (R_a, t_a, R_b, t_b))
    return _max(float(torch.linalg.vector_norm(t_a - t_b)),
                DEPTH_M * float(torch.abs(R_a - R_b).max()))


def _births(pt, born: torch.Tensor) -> dict:
    """{(origin keyframe slot, origin pixel): [position, ...]} of the
    points born in a step: a point born of a seed keeps the seed's
    keyframe and pixel, so the same seed gives the same key on both
    sides."""
    kf = pt.orig_kf[:-1][born].tolist()
    px = pt.orig_px[:-1][born].tolist()
    pos = pt.pos[:-1][born].double().cpu()
    out = {}
    for i, (k, (x, y)) in enumerate(zip(kf, px)):
        out.setdefault((k, x, y), []).append(pos[i])
    return out


def _kept(pt, pt_0) -> torch.Tensor:
    """Slots that still hold the point they held before the step (the
    same origin): a slot freed in the step and handed to a birth holds
    another point."""
    return (pt.ptype[:-1] != 0) & (pt_0.ptype[:-1] != 0) \
        & (pt.orig_kf[:-1] == pt_0.orig_kf[:-1]) \
        & (pt.orig_px[:-1] == pt_0.orig_px[:-1]).all(-1)


def map_gaps(m_a, m_b, m_0=None) -> Dict[str, float]:
    """``map_gap_m``, ``kf_mismatch`` and ``map_mismatch`` of two maps after a step (the
    program's and the reference's: any objects with the map's fields)
    that both started from ``m_0`` (None: from nothing).

    A point that existed in ``m_0`` keeps its slot, and is compared slot
    by slot where both sides kept it (a slot is the same point while it
    holds the same origin); one kept on one side only is a mismatch.
    Points born in the step are compared as sets, since a pool hands out
    slots in order and one more birth or deletion (a seed converging, or
    a point dropped, on one side of a threshold) shifts every later
    slot: by their origin (the seed's keyframe and pixel; a point born on
    one side only is a mismatch).  Seeds that existed in ``m_0`` are
    compared by slot and those born by their count.  Keyframes are
    compared slot by slot.  The pools' last row is scratch and left
    out."""
    kf_a, kf_b = m_a.kf, m_b.kf
    act_a, act_b = kf_a.active[:-1], kf_b.active[:-1]
    both = act_a & act_b
    gap = 0.0
    if bool(both.any()):
        pa = _positions(kf_a.R[:-1][both], kf_a.t[:-1][both]).double()
        pb = _positions(kf_b.R[:-1][both], kf_b.t[:-1][both]).double()
        gap = _max(float(torch.linalg.vector_norm(pa - pb, dim=-1).max()),
                   DEPTH_M * float(torch.abs(kf_a.R[:-1][both].double()
                                             - kf_b.R[:-1][both].double())
                                   .max()))
    kf_mismatch = int((act_a != act_b).sum())
    mismatch = kf_mismatch

    ty_a, ty_b = m_a.pt.ptype[:-1], m_b.pt.ptype[:-1]
    if m_0 is not None:
        keep_a, keep_b = _kept(m_a.pt, m_0.pt), _kept(m_b.pt, m_0.pt)
    else:
        keep_a = keep_b = torch.zeros_like(ty_a, dtype=torch.bool)
    live = keep_a & keep_b
    mismatch += int((keep_a != keep_b).sum()) \
        + int(((ty_a != ty_b) & live).sum())
    if bool(live.any()):
        gap = _max(gap, float(torch.linalg.vector_norm(
            m_a.pt.pos[:-1][live].double() - m_b.pt.pos[:-1][live].double(),
            dim=-1).max()))
    born_a = _births(m_a.pt, (ty_a != 0) & ~keep_a)
    born_b = _births(m_b.pt, (ty_b != 0) & ~keep_b)
    for k in born_a.keys() | born_b.keys():
        a, b = born_a.get(k, []), born_b.get(k, [])
        if len(a) != len(b):
            mismatch += abs(len(a) - len(b))
            continue
        for pa, pb in zip(sorted(a, key=lambda p: p.tolist()),
                          sorted(b, key=lambda p: p.tolist())):
            gap = _max(gap, float(torch.linalg.vector_norm(pa - pb)))

    s_a, s_b = m_a.seed.active[:-1], m_b.seed.active[:-1]
    s_0 = m_0.seed.active[:-1] if m_0 is not None \
        else torch.zeros_like(s_a)
    mismatch += int(((s_a != s_b) & s_0).sum())
    mismatch += abs(int((s_a & ~s_0).sum()) - int((s_b & ~s_0).sum()))
    return {"map_gap_m": gap, "kf_mismatch": float(kf_mismatch),
            "map_mismatch": float(mismatch)}


def worst(readings) -> Dict[str, float]:
    """Each number's worst reading over a list of per-sample dicts."""
    out = {k: 0.0 for k in NUMBERS}
    for r in readings:
        for k in NUMBERS:
            if k in r:
                out[k] = _max(out[k], r[k])
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{number: {"value", "limit"}} and whether every value is within its
    limit; a number without a limit fails."""
    checks = {k: {"value": values[k], "limit": limits.get(k)}
              for k in NUMBERS}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return {"checks": checks, "correct": ok}
