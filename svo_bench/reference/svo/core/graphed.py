"""Stand-in for the port's ``core/graphed.py``: the reference runs every
function eagerly, so ``jit`` returns the function itself and no tensor is
ever "on the card" for a graph."""

from __future__ import annotations

from typing import Callable


def jit(fn: Callable | None = None, *, static_argnames=()):
    if fn is None:
        return lambda f: f
    return fn


def on_card(*tensors) -> bool:
    return False


def record_launch(kernel: str) -> None:
    """No kernel of the reference is ever captured."""


def _no_graph(*args, **kwargs):
    raise RuntimeError("the reference runs no CUDA graph")


run = run_kept = slot = fresh_copy = _no_graph
