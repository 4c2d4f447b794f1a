"""Carry a tracking state across packages as nested dicts of numpy arrays.

``state_from_numpy`` builds the port's ``VOState`` from the JAX
``VOState`` given as nested dicts of numpy arrays (the field names of the
JAX NamedTuples; the padded pyramid as ``{"stack": ..., "shapes": ...}``).
Field types map one to one: float32, int32 and bool.  ``state_to_numpy``
is the inverse, for comparisons.

``handler_from_numpy`` does the same for the host pipeline: it builds the
port's ``FrameHandler`` from the JAX ``FrameHandler``'s state (the map,
the last frame, the stage, ``num_obs_last``, ``next_id`` and the
bootstrap's ``InitState``, reference KLT pyramid and first frame), so a
run can continue in the port from any point of a JAX run.  A frame is a
dict of its ``FrameState`` fields with the pyramid as ``pad`` alone (the
level views and the flat view are views of it); ``handler_to_numpy`` is
the inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from rpg_svo_tpu_torch import resolve_device
from rpg_svo_tpu_torch.core.frame import FrameState
from rpg_svo_tpu_torch.core.fused import VOState
from rpg_svo_tpu_torch.core.map import (
    KeyframeStore, MapState, PointStore, SeedStore)
from rpg_svo_tpu_torch.ops.tiles import PaddedPyramid


def _t(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _nt(cls, d, dev):
    return cls(**{k: _t(d[k], dev) for k in cls._fields})


def map_from_numpy(m: dict, device=None) -> MapState:
    """The port's MapState from its nested dicts of numpy arrays."""
    dev = resolve_device(device)
    return MapState(kf=_nt(KeyframeStore, m["kf"], dev),
                    pt=_nt(PointStore, m["pt"], dev),
                    seed=_nt(SeedStore, m["seed"], dev),
                    kf_counter=_t(m["kf_counter"], dev))


def _pad(d: dict, dev) -> PaddedPyramid:
    return PaddedPyramid.from_stack(_t(d["stack"], dev), d["shapes"])


def state_from_numpy(tree: dict, device=None) -> VOState:
    """The port's VOState from nested dicts of numpy arrays."""
    dev = resolve_device(device)
    rest = {k: _t(tree[k], dev) for k in VOState._fields
            if k not in ("m", "pad")}
    return VOState(m=map_from_numpy(tree["m"], dev), pad=_pad(tree["pad"], dev),
                   **rest)


def frame_from_numpy(d: dict, device=None) -> FrameState:
    """A FrameState from the dict of its fields (``pad`` as above)."""
    dev = resolve_device(device)
    pad = _pad(d["pad"], dev)
    rest = {k: _t(d[k], dev) for k in FrameState._fields
            if k not in ("pyr", "pad", "flat", "timestamp")}
    return FrameState(pyr=pad.levels(), pad=pad, flat=pad.flat_view(),
                      timestamp=float(d["timestamp"]), **rest)


def handler_from_numpy(tree: dict, cam, cfg, img_shape, device=None):
    """The port's FrameHandler in the state ``tree`` describes: ``map``,
    ``last_frame`` (or None), ``stage``, ``quality``, ``num_obs_last``,
    ``next_id``, and ``init`` with the bootstrap's ``state`` (the InitState
    fields, or None), ``ref_pyr`` (level images, or None) and ``frame0``
    (the first bootstrap frame, or None)."""
    from rpg_svo_tpu_torch.core.initialization import InitState
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    dev = resolve_device(device)
    fh = FrameHandler(cam, cfg, img_shape, device=dev)
    fh.map = map_from_numpy(tree["map"], dev)
    if tree["last_frame"] is not None:
        fh.last_frame = frame_from_numpy(tree["last_frame"], dev)
    fh.stage = tree["stage"]
    fh.quality = tree["quality"]
    fh.num_obs_last = int(tree["num_obs_last"])
    fh.next_id = int(tree["next_id"])
    init = tree["init"]
    if init["state"] is not None:
        fh.initializer.state = _nt(InitState, init["state"], dev)
        fh.initializer.ref_pyr = tuple(_t(a, dev) for a in init["ref_pyr"])
    if init["frame0"] is not None:
        fh._init_frame0 = frame_from_numpy(init["frame0"], dev)
    return fh


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, PaddedPyramid):
        return {"stack": _np(x.stack), "shapes": [list(s) for s in x.shapes]}
    if isinstance(x, FrameState):
        return {k: (v if k == "timestamp" else _np(v))
                for k, v in x._asdict().items() if k not in ("pyr", "flat")}
    return {k: _np(v) for k, v in x._asdict().items()}


def state_to_numpy(state: VOState) -> dict:
    """Nested dicts of numpy arrays, in the layout state_from_numpy reads."""
    return _np(state)


def handler_to_numpy(fh) -> dict:
    """The layout handler_from_numpy reads."""
    ini = fh.initializer
    frame0 = fh._init_frame0
    return {
        "map": _np(fh.map),
        "last_frame": None if fh.last_frame is None else _np(fh.last_frame),
        "stage": fh.stage, "quality": fh.quality,
        "num_obs_last": fh.num_obs_last, "next_id": fh.next_id,
        "init": {"state": None if ini.state is None else _np(ini.state),
                 "ref_pyr": None if ini.ref_pyr is None
                 else [_np(a) for a in ini.ref_pyr],
                 "frame0": None if frame0 is None else _np(frame0)}}
