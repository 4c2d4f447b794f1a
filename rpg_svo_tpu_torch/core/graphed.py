"""The donated step as one CUDA graph, captured once and replayed per frame.

Port-only: no file of ``rpg_svo_tpu/`` corresponds.  The JAX package jits
its donated step (``rpg_svo_tpu/core/fused.py:461-464``), so a frame is
one dispatch and a scan of frames is a host loop of dispatches with no
synchronization.  Eager PyTorch issues the same step as ~9k launches
from Python; ``run`` issues it as one ``torch.cuda.CUDAGraph`` replay.

A graph holds raw addresses, so it is keyed by the static arguments, the
image's shape and dtype, the device, and the storage (data pointer,
shape, strides, dtype) of every leaf of the state.  The donated step
writes every leaf in place (``core/fused._donated_step``), so the state's
addresses are a fixed point of the step and one graph serves every later
frame of that state.  The first call for a key runs the step eagerly on a
side stream (that frame's result; it also warms the kernels, the device
tables and the allocator), then captures it under sync-debug ``"error"``:
capture executes nothing, so the state is not advanced twice.  A replay
copies the image into the graph's image buffer, launches the graph, and
returns clones of its outputs.  A capture that fails raises: the card has
no eager fallback here (``vo_step`` is the eager step).

The constant device tables a step reads (``ops/tiles._level_table``,
``core/reprojector._cell_perm``) are cached for the life of the process,
so no graph outlives a table it reads.  At most ``MAX_GRAPHS`` graphs are
kept, least recently used first out; dropping one frees its private
memory pool.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch
import torch.utils._pytree as pytree

# each graph keeps its step's intermediates in a private pool (25-85 MB
# in the bench presets on the H100, PERF.md): room for the eight stage
# ablations of one state beside a few other states
MAX_GRAPHS = 16


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    img: torch.Tensor           # the image buffer the graph reads
    out: tuple                  # the outputs the graph writes (NamedTuple)
    capture_s: float            # the capture alone, after the eager step
    pool_mb: float              # device memory the capture reserved


_graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()


def graph_key(static, state, img: torch.Tensor) -> tuple:
    """The key of the graph that steps ``state`` on ``img``: the static
    arguments, the image's shape and dtype, the state's device, and the
    storage of every state leaf."""
    leaves = pytree.tree_leaves(state)
    return (static, tuple(img.shape), img.dtype, leaves[0].device,
            tuple((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
                  for x in leaves))


def run(step: Callable, static, state, img: torch.Tensor):
    """``step(state, img) -> (state, out)``, a donated step on a CUDA
    state that writes every leaf of ``state`` in place, as a replay of the
    graph of ``graph_key(static, state, img)``; captured on the first call
    for that key.  ``out`` is a NamedTuple of tensors, returned as
    copies."""
    key = graph_key(static, state, img)
    g = _graphs.get(key)
    if g is None:
        out, _graphs[key] = _capture(step, state, img)
        while len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)
        return state, out
    _graphs.move_to_end(key)
    g.img.copy_(img)
    g.graph.replay()
    return state, type(g.out)(*(t.clone() for t in g.out))


def _capture(step: Callable, state, img: torch.Tensor):
    """(the eager step's outputs, the captured graph) of one key."""
    dev = pytree.tree_leaves(state)[0].device
    with torch.cuda.device(dev):
        static_img = torch.empty(img.shape, dtype=img.dtype, device=dev)
        static_img.copy_(img)
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            _, out = step(state, static_img)
        cur.wait_stream(side)
        for t in out:
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            reserved = torch.cuda.memory_reserved()
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, static_out = step(state, static_img)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        pool_mb = (torch.cuda.memory_reserved() - reserved) / 1e6
        return out, _Graph(graph, static_img, static_out,
                           time.perf_counter() - t0, pool_mb)


def graphs() -> list:
    """(key, capture seconds, pool MB) of each graph kept, oldest first."""
    return [(k, g.capture_s, g.pool_mb) for k, g in _graphs.items()]


def clear() -> None:
    """Drop every graph (and its memory pool)."""
    _graphs.clear()
