"""The fused step's entries as CUDA graphs, captured once and replayed.

Port-only: no file of ``rpg_svo_tpu/`` corresponds.  The JAX package jits
each entry of the step (``vo_step`` and its donated twin,
``rpg_svo_tpu/core/fused.py:461-464``; ``vo_scan`` as one ``lax.scan``,
``:513-524``; ``vmapped_vo_step``, ``rpg_svo_tpu/parallel/streams.py:
46-55``), so a frame is one dispatch.  Eager PyTorch issues the same step
as ~9k launches from Python; ``run`` issues it as one
``torch.cuda.CUDAGraph`` replay.

A graph holds raw addresses, so ``run`` keys it by the static arguments,
the image's shape and dtype, the device, the ambient mesh
(``parallel/gspmd.use_mesh``) and the storage (data pointer, shape,
strides, dtype) of every leaf of the state.  The step it runs writes
every leaf in place (``core/fused._donated_step``), so the state's
addresses are a fixed point of the step and one graph serves every later
frame of that state.  The first call for a key runs the step eagerly on a
side stream (that frame's result; it also warms the kernels, the device
tables, the allocator and any NCCL communicator), then captures it under
sync-debug ``"error"``: capture executes nothing, so the state is not
advanced twice.  A replay copies the image into the graph's image buffer,
launches the graph, and returns clones of its outputs.  A capture that
fails raises: no entry falls back to the eager step on the card.

The entries that keep their input state (``vo_step``, ``vo_scan``,
``vmapped_vo_step``) receive a new state object every call.  ``run_kept``
serves them from a *slot*: a graph-owned state keyed like a graph but by
each leaf's shape, strides and dtype instead of its pointer, so a clone of
a state finds the same slot.  A call copies the caller's leaves into the
slot (one ``torch._foreach_copy_`` per dtype), steps the slot through
``run`` (the first call for a slot captures, later calls replay), and
returns a new state of fresh copies of the slot's leaves.

The constant device tables a step reads (``ops/tiles._level_table``,
``core/reprojector._cell_perm``) are cached for the life of the process,
so no graph outlives a table it reads.  At most ``MAX_GRAPHS`` graphs and
as many slots are kept, least recently used first out; dropping a graph
frees its private memory pool, dropping a slot drops its graph.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch import is_batched
from rpg_svo_tpu_torch.parallel.gspmd import ambient_mesh

# each graph keeps its step's intermediates in a private pool (25-85 MB
# in the bench presets on the H100, PERF.md): room for the eight stage
# ablations of one state beside a few other states; as many slots
MAX_GRAPHS = 16


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    img: torch.Tensor           # the image buffer the graph reads
    out: tuple                  # the outputs the graph writes (NamedTuple)
    capture_s: float            # the capture alone, after the eager step
    pool_mb: float              # device memory the capture reserved


class _Slot(NamedTuple):
    state: object               # the graph-owned state the graph steps
    graph_key: tuple            # the key of that graph in _graphs
    mb: float                   # the state's device memory


_graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
_slots: "OrderedDict[tuple, _Slot]" = OrderedDict()


def on_card(*tensors) -> bool:
    """Whether an entry steps these tensors (a state's leaves, images) as
    a CUDA graph: on a card, and outside ``torch.func.vmap``."""
    return tensors[0].is_cuda and not is_batched(*tensors)


def _signature(static, leaves, img: torch.Tensor) -> tuple:
    return (static, tuple(img.shape), img.dtype, leaves[0].device,
            ambient_mesh())


def graph_key(static, state, img: torch.Tensor) -> tuple:
    """The key of the graph that steps ``state`` on ``img``: the static
    arguments, the image's shape and dtype, the state's device, the
    ambient mesh and the storage of every state leaf."""
    leaves = pytree.tree_leaves(state)
    return _signature(static, leaves, img) + tuple(
        (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype) for x in leaves)


def slot_key(static, state, img: torch.Tensor) -> tuple:
    """The key of the slot that serves ``state`` on ``img``: as
    ``graph_key`` but with each leaf's shape, strides and dtype, not its
    pointer."""
    leaves = pytree.tree_leaves(state)
    return _signature(static, leaves, img) + tuple(
        (tuple(x.shape), x.stride(), x.dtype) for x in leaves)


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


def _copy_leaves(dst: list, src: list) -> None:
    """dst[i].copy_(src[i]) for all i, as one ``_foreach_copy_`` per dtype
    (the fused copy needs one dtype per list)."""
    by_dtype: dict = {}
    for d, s in zip(dst, src):
        pair = by_dtype.setdefault(s.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for d, s in by_dtype.values():
        torch._foreach_copy_(d, s)


def fresh_copy(state):
    """A copy of ``state`` in new storage (each leaf's strides kept where
    it is dense)."""
    leaves, spec = pytree.tree_flatten(state)
    out = [torch.empty_like(x) for x in leaves]
    _copy_leaves(out, leaves)
    return pytree.tree_unflatten(out, spec)


def slot(static, state, img: torch.Tensor):
    """The slot of ``slot_key(static, state, img)`` holding a copy of
    ``state``: made on the first call for that key, written in place
    later."""
    key = slot_key(static, state, img)
    s = _slots.get(key)
    if s is None:
        own = fresh_copy(state)
        mb = sum(x.numel() * x.element_size()
                 for x in pytree.tree_leaves(own)) / 1e6
        _slots[key] = _Slot(own, graph_key(static, own, img), mb)
        while len(_slots) > MAX_GRAPHS:
            _graphs.pop(_slots.popitem(last=False)[1].graph_key, None)
        return own
    _slots.move_to_end(key)
    _copy_leaves(pytree.tree_leaves(s.state), pytree.tree_leaves(state))
    return s.state


def run_kept(step: Callable, static, state, img: torch.Tensor):
    """``run`` for an entry that keeps its input: ``state`` is copied into
    its slot, the slot is stepped by ``run``, and the result is a new
    state of copies of the slot's leaves, with copies of the outputs.
    ``state`` is left as it was."""
    own = slot(static, state, img)
    _, out = run(step, static, own, img)
    return fresh_copy(own), out


def graphs() -> list:
    """(key, capture seconds, pool MB) of each graph kept, oldest first."""
    return [(k, g.capture_s, g.pool_mb) for k, g in _graphs.items()]


def slots() -> list:
    """(key, slot MB, capture seconds, pool MB) of each slot kept, oldest
    first; the last two None while its graph is not (or no longer)
    kept."""
    out = []
    for k, s in _slots.items():
        g = _graphs.get(s.graph_key)
        out.append((k, s.mb) + ((None, None) if g is None
                                else (g.capture_s, g.pool_mb)))
    return out


def clear() -> None:
    """Drop every slot and every graph (and its memory pool)."""
    _slots.clear()
    _graphs.clear()
