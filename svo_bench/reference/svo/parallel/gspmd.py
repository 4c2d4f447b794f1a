"""Stand-in for the port's ``parallel/gspmd.py``: the reference runs on
one device, so every collective over the (always empty) shard axis
returns its input."""

from __future__ import annotations


def _single(tree, axis, mesh=None):
    if axis:
        raise RuntimeError("the reference runs on one device")
    return tree


psum = shard_dim0 = gather_dim0 = _single


def ambient_mesh():
    return None
