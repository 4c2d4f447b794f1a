"""Map consistency validation and statistics.

Port of ``rpg_svo_tpu/core/map_debug.py`` (map_debug, svo/src/map.cpp:
297-365): cross-checks the keyframe <-> point references of the pooled
map and reports its statistics.  Reads the map to the host and checks it
with numpy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from rpg_svo_tpu_torch.core.map import TYPE_CANDIDATE, TYPE_DELETED, MapState


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def validate_map(m: MapState) -> List[str]:
    """The violations found (empty: consistent)."""
    errors = []
    active_kf = _np(m.kf.active)
    ptype = _np(m.pt.ptype)
    feat_point = _np(m.kf.feat_point)
    feat_valid = _np(m.kf.feat_valid)
    obs_kf = _np(m.pt.obs_kf)
    obs_feat = _np(m.pt.obs_feat)
    obs_valid = _np(m.pt.obs_valid)
    K = active_kf.shape[0]
    P = ptype.shape[0]
    F = feat_point.shape[1]

    # 1. keyframe features reference live points
    for k in range(K):
        if not active_kf[k]:
            continue
        pids = feat_point[k][feat_valid[k]]
        pids = pids[pids >= 0]
        if (pids >= P).any():
            errors.append(f"kf{k}: feature point id out of range")
            continue
        dead = ptype[pids] == TYPE_DELETED
        if dead.any():
            errors.append(
                f"kf{k}: {int(dead.sum())} features reference deleted points")

    # 2. point observations reference active keyframes whose feature
    #    points back (Point::findFrameRef semantics)
    for p, _ in np.argwhere(obs_valid):
        if ptype[p] == TYPE_DELETED:
            errors.append(f"pt{p}: deleted point has live observation")
            break
    live_obs = obs_valid & (ptype != TYPE_DELETED)[:, None]
    bad_kf = live_obs & ((obs_kf < 0) | (obs_kf >= K))
    if bad_kf.any():
        errors.append(f"{int(bad_kf.sum())} observations with invalid kf")
    ok = live_obs & ~bad_kf
    kf_idx = np.clip(obs_kf, 0, K - 1)
    inactive = ok & ~active_kf[kf_idx]
    if inactive.any():
        errors.append(
            f"{int(inactive.sum())} observations on inactive keyframes")
    back = feat_point[kf_idx, np.clip(obs_feat, 0, F - 1)]
    mismatch = ok & ~inactive & (back != np.arange(P)[:, None])
    if mismatch.any():
        errors.append(
            f"{int(mismatch.sum())} observations whose keyframe feature "
            "does not point back")

    # 3. seeds reference active keyframes
    seed_act = _np(m.seed.active)
    seed_kf = _np(m.seed.kf_slot)
    bad_seed = seed_act & ((seed_kf < 0) | (seed_kf >= K))
    if bad_seed.any():
        errors.append(f"{int(bad_seed.sum())} seeds with invalid kf slot")
    dead_kf = seed_act & ~bad_seed & ~active_kf[np.clip(seed_kf, 0, K - 1)]
    if dead_kf.any():
        errors.append(f"{int(dead_kf.sum())} seeds on inactive keyframes")
    return errors


def map_statistics(m: MapState) -> Dict[str, int]:
    """mapStatistics: keyframe, point, observation and seed counts."""
    ptype = _np(m.pt.ptype)
    live = ptype != TYPE_DELETED
    n_obs = int((_np(m.pt.obs_valid) & live[:, None]).sum())
    return {
        "n_keyframes": int(_np(m.kf.active).sum()),
        "n_points": int(live.sum()),
        "n_candidates": int((ptype == TYPE_CANDIDATE).sum()),
        "n_observations": n_obs,
        "n_seeds": int(_np(m.seed.active).sum()),
        "avg_obs_per_point": float(n_obs / max(live.sum(), 1)),
    }
