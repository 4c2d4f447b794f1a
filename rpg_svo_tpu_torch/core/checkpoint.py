"""Map and pipeline state checkpoints.

Port of ``rpg_svo_tpu/core/checkpoint.py``.  The reference has no
persistence (a reset rebuilds from scratch); the map is a tree of fixed
capacity tensors, so a checkpoint is its leaves in one numpy ``.npz``.
The files are the JAX package's layout: the leaves in the field order of
the NamedTuples (the port's ``MapState`` and ``FrameState`` mirror the JAX
ones field by field), the frame's pyramid as its level images.  A
checkpoint saved by either package resumes in the other.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from rpg_svo_tpu_torch.core.frame import FrameState
from rpg_svo_tpu_torch.core.map import MapState
from rpg_svo_tpu_torch.ops.tiles import PaddedPyramid

# the FrameState fields a checkpoint holds after the pyramid levels
_FRAME_FIELDS = ("R", "t", "frame_id", "timestamp", "feat_px", "feat_f",
                 "feat_level", "feat_point", "feat_valid", "feat_type",
                 "feat_grad")


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested NamedTuples, depth first in field order (the
    order of jax.tree.flatten)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for v in tree for x in _leaves(v)]


def _rebuild(template, it):
    """template's structure with its leaves taken in order from it."""
    if isinstance(template, torch.Tensor):
        return next(it)
    return type(template)(*(_rebuild(v, it) for v in template))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _map_from(arrays: List[np.ndarray], template: MapState) -> MapState:
    flat_t = _leaves(template)
    if len(arrays) != len(flat_t):
        raise ValueError(f"checkpoint has {len(arrays)} map leaves, the "
                         f"template {len(flat_t)} (capacity or config "
                         "mismatch)")
    leaves = []
    for a, b in zip(arrays, flat_t):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"checkpoint/config capacity mismatch: "
                             f"{a.shape} vs {tuple(b.shape)}")
        leaves.append(torch.from_numpy(np.array(a, copy=True)).to(
            device=b.device, dtype=b.dtype))
    return _rebuild(template, iter(leaves))


def save_map(path: str, m: MapState) -> None:
    flat = _leaves(m)
    np.savez_compressed(path, n_leaves=len(flat),
                        **{f"leaf_{i}": _host(x) for i, x in enumerate(flat)})


def load_map(path: str, template: MapState) -> MapState:
    """The map saved at path, on the template's device; the template gives
    the structure and capacities."""
    with np.load(path) as data:
        arrays = [data[f"leaf_{i}"] for i in range(int(data["n_leaves"]))]
    return _map_from(arrays, template)


def save_handler(path: str, fh) -> None:
    """Checkpoint a FrameHandler's tracking state (the map, the last
    frame, the stage), enough to resume add_image mid-sequence."""
    flat = _leaves(fh.map)
    lf = fh.last_frame
    frame_leaves = list(lf.pyr) + [getattr(lf, k) for k in _FRAME_FIELDS]
    np.savez_compressed(
        path, n_map=len(flat), n_frame=len(frame_leaves),
        stage=fh.stage, quality=fh.quality,
        next_id=fh.next_id, num_obs_last=fh.num_obs_last,
        **{f"m_{i}": _host(x) for i, x in enumerate(flat)},
        **{f"f_{i}": _host(x) for i, x in enumerate(frame_leaves)})


def load_handler(path: str, fh) -> None:
    """Restore the state save_handler wrote into a handler of the same
    configuration, on the handler's device."""
    dev = fh.device
    with np.load(path) as data:
        fh.map = _map_from([data[f"m_{i}"] for i in range(int(data["n_map"]))],
                           fh.map)
        fr = [data[f"f_{i}"] for i in range(int(data["n_frame"]))]
        stage, quality = str(data["stage"]), str(data["quality"])
        next_id, num_obs = int(data["next_id"]), int(data["num_obs_last"])
    n_lv = fh.n_levels

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)
    pad = PaddedPyramid.from_levels([t(a, np.float32) for a in fr[:n_lv]])
    rest = dict(zip(_FRAME_FIELDS, fr[n_lv:n_lv + len(_FRAME_FIELDS)]))
    fh.last_frame = FrameState(
        pyr=pad.levels(), pad=pad, flat=pad.flat_view(),
        R=t(rest["R"], np.float32), t=t(rest["t"], np.float32),
        frame_id=t(rest["frame_id"], np.int32),
        timestamp=float(rest["timestamp"]),
        feat_px=t(rest["feat_px"], np.float32),
        feat_f=t(rest["feat_f"], np.float32),
        feat_level=t(rest["feat_level"], np.int32),
        feat_point=t(rest["feat_point"], np.int32),
        feat_valid=t(rest["feat_valid"], np.bool_),
        feat_type=t(rest["feat_type"], np.int32),
        feat_grad=t(rest["feat_grad"], np.float32))
    fh.stage = stage
    fh.quality = quality
    fh.next_id = next_id
    fh.num_obs_last = num_obs
