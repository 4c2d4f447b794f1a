"""The port's ``jax.jit``: CUDA graphs, captured once and replayed.

Port-only: no file of ``rpg_svo_tpu/`` corresponds.  ``jit`` (at the end
of this module) wraps every other function the JAX package passes to
``jax.jit``: the stages ``FrameHandler`` calls one by one, the BA solves,
the bootstrap's KLT and homography, the renderers.  The JAX package jits
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
fails raises: no entry falls back to the eager step on the card.  ``jit``
captures the same way (``_capture_graph``).  A kernel launch recorded in
a capture is counted at each replay of its graph (``replayed_launches``);
the kernel's wrapper counts only the launches it makes itself.

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

With spans on (``core/spans.py``) each entry call is a host span
(``graphed.run``, ``graphed.run_kept``, ``jit.<function>``: no events)
and each replay a span ``replay`` timed by events around it.  The
switch is part of the graph and slot keys: a graph captured with spans
on holds the step's stage boundaries as event nodes, and every replay of
it yields that frame's stage spans; one captured with them off holds
none.  The MB a slot copies in and out are always counted
(``kept_copy_stats``).

A stage that the step runs masked on a device predicate may be a
``gate`` (the fused step's depth-filter update and keyframe stages): in a
``run`` capture it is a CUDA-graph IF node on that predicate
(``csrc/graph_gate.cu``), elsewhere the masked stage itself; its counters
(``gate_stats``) are kept on the card.  A launch recorded inside a gate's
body counts only on the replays that ran the body (``replayed_launches``
reads the counters).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import threading
import time
import types
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch import is_batched
from rpg_svo_tpu_torch.core import spans
from rpg_svo_tpu_torch.parallel.gspmd import ambient_mesh

# each graph keeps its step's intermediates in a private pool (25-85 MB
# in the bench presets on the H100, PERF.md): room for the eight stage
# ablations of one state beside a few other states; as many slots
MAX_GRAPHS = 16


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    img: torch.Tensor           # the image buffer the graph reads
    out: tuple                  # the outputs the graph writes (NamedTuple)
    launches: dict              # kernel launches a replay makes, by kernel
    capture_s: float            # the capture alone, after the eager step
    pool_mb: float              # device memory the capture reserved
    marks: object               # its span boundaries (spans.Marks) or None
    gates: object = None        # its gates' memory pool (_Gates) or None


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
            ambient_mesh(), spans.ON)


def graph_key(static, state, img: torch.Tensor) -> tuple:
    """The key of the graph that steps ``state`` on ``img``: the static
    arguments, the image's shape and dtype, the state's device, the
    ambient mesh, whether spans are on (a graph captured with them holds
    its stages' boundary events) and the storage of every state leaf."""
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
    copies.  With spans on, the call is a host span ``graphed.run``."""
    if spans.ON:
        with spans.span("graphed.run", None, None):
            return _run(step, static, state, img)
    return _run(step, static, state, img)


def _run(step: Callable, static, state, img: torch.Tensor):
    key = graph_key(static, state, img)
    g = _graphs.get(key)
    if g is None:
        out, _graphs[key] = _capture(step, state, img)
        while len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)
        return state, out
    _graphs.move_to_end(key)
    g.img.copy_(img)
    _replay_graph(g.graph, g.launches, g.img.device, g.marks)
    return state, type(g.out)(*(t.clone() for t in g.out))


def _capture(step: Callable, state, img: torch.Tensor):
    """(the eager step's outputs, the captured graph) of one key; with
    spans on, the step's span boundaries are captured as event nodes."""
    dev = pytree.tree_leaves(state)[0].device
    with torch.cuda.device(dev):
        static_img = torch.empty(img.shape, dtype=img.dtype, device=dev)
        static_img.copy_(img)
    marks = spans.Marks(dev) if spans.ON else None
    c = _capture_graph(step, (state, static_img), {}, dev, marks,
                       gates=True)
    return c.eager[1], _Graph(c.graph, static_img, c.out[1], c.launches,
                              c.capture_s, c.pool_mb,
                              marks if marks and marks.events else None,
                              c.gates)


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


# MB the kept-state entries copy into their slots and out of them
# (``slot``, ``fresh_copy``), always counted
_kept = {"in_copied_mb": 0.0, "out_copied_mb": 0.0}


def _copy(state):
    leaves, spec = pytree.tree_flatten(state)
    out = [torch.empty_like(x) for x in leaves]
    _copy_leaves(out, leaves)
    return pytree.tree_unflatten(out, spec)


def fresh_copy(state):
    """A copy of ``state`` in new storage (each leaf's strides kept where
    it is dense); counted as copied out (``kept_copy_stats``)."""
    _kept["out_copied_mb"] += _mb(pytree.tree_leaves(state))
    return _copy(state)


def slot(static, state, img: torch.Tensor):
    """The slot of ``slot_key(static, state, img)`` holding a copy of
    ``state``: made on the first call for that key, written in place
    later; counted as copied in (``kept_copy_stats``)."""
    key = slot_key(static, state, img)
    s = _slots.get(key)
    if s is None:
        own = _copy(state)
        s = _slots[key] = _Slot(own, graph_key(static, own, img),
                                _mb(pytree.tree_leaves(own)))
        while len(_slots) > MAX_GRAPHS:
            _graphs.pop(_slots.popitem(last=False)[1].graph_key, None)
    else:
        _slots.move_to_end(key)
        _copy_leaves(pytree.tree_leaves(s.state), pytree.tree_leaves(state))
    _kept["in_copied_mb"] += s.mb
    return s.state


def run_kept(step: Callable, static, state, img: torch.Tensor):
    """``run`` for an entry that keeps its input: ``state`` is copied into
    its slot, the slot is stepped by ``run``, and the result is a new
    state of copies of the slot's leaves, with copies of the outputs.
    ``state`` is left as it was.  With spans on, the call is a host span
    ``graphed.run_kept``."""
    if spans.ON:
        with spans.span("graphed.run_kept", None, None):
            return _run_kept(step, static, state, img)
    return _run_kept(step, static, state, img)


def _run_kept(step: Callable, static, state, img: torch.Tensor):
    own = slot(static, state, img)
    _, out = run(step, static, own, img)
    return fresh_copy(own), out


def kept_copy_stats() -> dict:
    """MB copied into the slots (``in_copied_mb``) and out of them
    (``out_copied_mb``) since ``reset_jit_counts``."""
    return dict(_kept)


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
    """Drop every slot and every graph (and its memory pool), the stage
    graphs of every ``jit`` function too."""
    _slots.clear()
    _graphs.clear()
    for f in _jitted:
        f.clear()
    _buffers.clear()


@contextlib.contextmanager
def _sync_error():
    """Sync-debug ``"error"``: a host sync raises (inside a capture)."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


# ---------------------------------------------------------------------------
# jit: the counterpart of jax.jit for functional functions
#
# A wrapped function called from host code on CUDA tensors is one replay of
# a graph keyed by the function, its static arguments, every non-tensor leaf
# of its other arguments, the shape, strides, dtype and device of every
# tensor leaf and the ambient mesh.  A key owns input buffers: a call copies
# the tensor leaves in (one ``_foreach_copy_`` per dtype), replays, and
# returns copies of the outputs; an output that is one of the graph's own
# input buffers (``m._replace(pt=...)`` leaves the other pools alone) is
# returned as the caller's own tensor, as nothing on these paths writes a
# tensor in place (a capture checks each input buffer's version counter
# and raises where the body wrote one).  The first call for a key runs the body eagerly on a side
# stream (to warm up the kernels, tables and allocator), captures it under
# sync-debug "error" and replays it.  The body runs itself on the CPU, under
# ``torch.func.vmap``, inside ``disable()`` and while a graph is being
# traced (a capture, or the eager run before it), where JAX inlines a
# nested jit.  A capture that fails raises.

# stage graphs kept per function, least recently used first out: a handler
# frame replays ~9 distinct stage graphs and a keyframe ~12, each function
# with one or two signatures per camera and preset
JIT_MAX = 8

_local = threading.local()
_call_lock = threading.Lock()


def _flag(name: str) -> int:
    return getattr(_local, name, 0)


@contextlib.contextmanager
def _counting(name: str):
    setattr(_local, name, _flag(name) + 1)
    try:
        yield
    finally:
        setattr(_local, name, _flag(name) - 1)


def _tracing():
    """While a graph is being traced, wrapped functions run their body."""
    return _counting("tracing")


def disable():
    """The counterpart of ``jax.disable_jit()``: inside it every ``jit``
    function runs its body eagerly (the eager references of the card
    checks)."""
    return _counting("disabled")


class _StageGraph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: list                # the input buffers, one per tensor leaf
    args: tuple                 # the arguments it was captured with, kept
    #                             alive with any tensor their nodes hold
    spec: object                # the outputs' tree structure
    outs: list                  # per output leaf: ("copy", tensor),
    #                             ("input", leaf index) or ("const", value)
    launches: dict              # kernel launches a replay makes, by kernel
    capture_s: float
    in_mb: float                # the input buffers it reads (shared)
    pool_mb: float              # device memory the capture reserved


_SCALARS = (type(None), bool, int, str, torch.dtype, torch.device,
            types.FunctionType)


def _key_leaf(x):
    """A non-tensor leaf as part of a key (floats by their bits, so that
    -0.0 and NaN key as themselves; a dataclass, such as a renderer's
    surface or a Config, by its fields); raises on anything else, which
    could hide a tensor or not be hashable."""
    if isinstance(x, float):
        return (float, x.hex())
    if isinstance(x, _SCALARS):
        return (type(x), x)
    if isinstance(x, functools.partial):        # local BA's mesh reduce
        return (functools.partial, _key_leaf(x.func), _key_leaf(x.args),
                tuple(sorted((k, _key_leaf(v))
                             for k, v in x.keywords.items())))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x),) + tuple(
            _key_leaf(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return (tuple,) + tuple(_key_leaf(v) for v in x)
    raise TypeError(f"graphed.jit: an argument leaf of type "
                    f"{type(x).__name__} is neither a tensor nor a value; "
                    f"register its type as a pytree node or make the "
                    f"argument static")


def _static_key(x):
    """A static argument as part of a key: a value as ``_key_leaf`` keys
    it, else the object itself, which must be hashable (as JAX asks of a
    static argument; a mesh, say)."""
    if isinstance(x, torch.Tensor):
        raise TypeError("graphed.jit: a tensor cannot be a static argument")
    try:
        return _key_leaf(x)
    except TypeError:
        hash(x)
        return (type(x), x)


# the input buffers, shared by every graph: the j-th leaf of a call with a
# given (shape, strides, dtype, device) reads the j-th buffer of that
# signature.  A call copies all its inputs in before its replay, and no
# replay runs while another call's inputs are copied, so stages that take
# the same map share one copy of it.
_buffers: dict = {}


def _shared_buffers(tensors: list) -> list:
    seen: dict = {}
    out = []
    for x in tensors:
        sig = (tuple(x.shape), x.stride(), x.dtype, x.device)
        j = seen[sig] = seen.get(sig, -1) + 1
        pool = _buffers.setdefault(sig, [])
        if len(pool) <= j:
            pool.append(torch.empty_like(x))
        out.append(pool[j])
    return out


def buffer_mb() -> float:
    """Device memory of the shared input buffers."""
    return _mb(b for pool in _buffers.values() for b in pool)


def _mb(ts) -> float:
    return sum(t.numel() * t.element_size() for t in ts) / 1e6


def _jit_on_card(tensors: list) -> bool:
    """Whether a call on these tensor leaves replays a graph: on a card,
    outside ``torch.func.vmap`` and outside a capture."""
    return bool(tensors) and tensors[0].is_cuda \
        and not is_batched(*tensors) \
        and not torch.cuda.is_current_stream_capturing()


class _Capture(NamedTuple):
    eager: object               # the eager run's outputs
    graph: "torch.cuda.CUDAGraph"
    out: object                 # the outputs the graph writes
    launches: dict              # kernel launches recorded, by kernel
    capture_s: float            # the capture alone, after the eager run
    pool_mb: float              # device memory the capture reserved
    gates: object = None        # the gates' memory pool (_Gates) or None


def _capture_graph(fn: Callable, args, kwargs, dev: torch.device,
                   marks=None, gates: bool = False) -> _Capture:
    """``fn(*args, **kwargs)`` run eagerly on a side stream (it warms the
    kernels, the device tables, the allocator and any NCCL communicator),
    then captured under sync-debug "error"; span boundaries inside the
    capture go into ``marks`` (``spans.capturing``; None: nowhere).  With
    ``gates`` each ``gate`` of the capture is an IF node."""
    with torch.cuda.device(dev):
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side), _tracing():
            eager = fn(*args, **kwargs)
        cur.wait_stream(side)
        for t in pytree.tree_leaves(eager):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        ctx = _Gates(torch.cuda.MemPool(), _body_stream(dev)) if gates \
            else None
        graph = torch.cuda.CUDAGraph()
        launches: dict = {}
        t0 = time.perf_counter()
        # thread_local: another thread (an image prefetcher, a renderer
        # feeding frames) may use the card meanwhile; the capturing thread
        # is held to the capture's rules all the same
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved()
            with _sync_error(), _tracing(), _recording(launches), \
                    spans.capturing(marks), _gating(ctx):
                out = fn(*args, **kwargs)
        return _Capture(eager, graph, out, launches,
                        time.perf_counter() - t0,
                        (torch.cuda.memory_reserved() - reserved) / 1e6, ctx)


# kernel launches made by graph replays, by kernel.  A kernel's wrapper
# counts the launches it makes itself; one that it makes while a graph is
# captured is recorded into that graph instead (``record_launch``), and
# each replay of the graph adds what it recorded here.
_replayed: dict = {}


@contextlib.contextmanager
def _recording(launches: dict):
    prev = getattr(_local, "recording", None)
    _local.recording = launches
    try:
        yield
    finally:
        _local.recording = prev


def record_launch(kernel: str) -> None:
    """A kernel's wrapper launched ``kernel`` into the stream being
    captured: the graph captured here (if ``jit`` or ``run`` captures it)
    launches it at each replay."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        rec[kernel] = rec.get(kernel, 0) + 1


def _replay_graph(graph, launches: dict, device: torch.device,
                  marks=None) -> None:
    """``graph.replay()``; with spans on, inside a span ``replay`` timed by
    events around it, whose children are the stages ``marks`` bounds."""
    if spans.ON:
        spans.replay(graph, device, marks)
    else:
        graph.replay()
    for k, n in launches.items():
        _replayed[k] = _replayed.get(k, 0) + n


def replayed_launches() -> dict:
    """Kernel launches made by graph replays since ``reset_jit_counts``,
    by kernel: those outside any gate at every replay, those inside a
    gate's body on the replays that ran it (read from the gate counters,
    a wait for the card when a graph has gated launches)."""
    out = dict(_replayed)
    rows = [(k, i) for k, i in _gate_rows.items() if k[2]]
    if rows:
        counts = {dev: t.tolist() for dev, t in _gate_tables.items()}
        for (dev, _, launches), i in rows:
            ran = counts[dev][i][1]
            for kernel, n in launches if ran else ():
                out[kernel] = out.get(kernel, 0) + n * ran
    return out


# ---------------------------------------------------------------------------
# gate: a stage that runs only where a device predicate holds
#
# The step's mapping stages run on some frames only (a depth-filter update
# every second frame, the keyframe stages on ~1%).  JAX picks them with
# ``lax.cond``; the port's step writes them masked, so that they run in
# every frame and leave the map as it was where their predicate is false,
# and the step needs no host read.  ``gate(name, pred, body, leaves)`` is
# such a masked stage: ``body(leaves)`` returns the new leaves, equal to
# ``leaves`` wherever ``pred`` is false.
#
# Outside a ``run`` capture (the CPU, the eager run before a capture, an
# eager reference, under vmap) it calls the body: the masked form.  Inside
# one it captures the body into the body of a CUDA-graph IF node on
# ``pred`` (``csrc/graph_gate.cu``: a one-thread kernel sets the node's
# condition from ``pred`` at every replay), on a stream of its own, its
# tensors in a memory pool that the graph keeps.  A replay then runs the
# body only where ``pred`` holds; where it runs, every mask in it passes,
# so its writes are the masked form's.  Whatever the rest of the graph
# reads after the node must be in the same storage whichever way the node
# went: the body ends by copying every leaf it replaced into the storage
# that leaf had before the node, and ``gate`` returns ``leaves``.  A gate
# inside a gate's body runs masked.
#
# ``gate_stats()`` counts, per gate, the steps that reached it and those
# on which its body ran (eager: its predicate held), on the card: a row of
# two int64 counters per gate name and set of kernel launches its body
# makes, incremented by the graph itself, read on the host only when
# asked for.


class _Gates(NamedTuple):
    pool: object                # torch.cuda.MemPool of the bodies' tensors
    stream: object              # the stream the bodies are captured on


GATE_ROWS = 64
_gate_tables: dict = {}         # device -> (GATE_ROWS, 2) int64 counters
_gate_rows: dict = {}           # (device, name, launches) -> row
_body_streams: dict = {}        # device -> the bodies' stream


def _body_stream(dev: torch.device):
    """The stream gate bodies are captured on: one of the package's own
    (no capture of PyTorch's can be using it), made once per card."""
    s = _body_streams.get(dev)
    if s is None:
        import ctypes
        from rpg_svo_tpu_torch.ops import cuda_build
        ptr = ctypes.c_void_p()
        fn = cuda_build.function("gate_stream",
                                 (ctypes.POINTER(ctypes.c_void_p),),
                                 "graph_gate")
        cuda_build.check(fn(ctypes.byref(ptr)), "gate_stream")
        s = _body_streams[dev] = torch.cuda.ExternalStream(ptr.value,
                                                           device=dev)
    return s


@contextlib.contextmanager
def _gating(ctx):
    prev = getattr(_local, "gates", None)
    _local.gates = ctx
    try:
        yield
    finally:
        _local.gates = prev


def _row(dev: torch.device, name: str, launches) -> torch.Tensor:
    """The counters (reached, ran) of gate ``name`` whose body makes
    ``launches``; the card's table is made outside any capture (the eager
    run before it passes every gate first)."""
    key = (dev, name, launches)
    i = _gate_rows.get(key)
    if i is None:
        table = _gate_tables.get(dev)
        if table is None:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"gate {name!r}: no counters on {dev} "
                                   f"before its first capture")
            table = _gate_tables[dev] = torch.zeros(
                (GATE_ROWS, 2), dtype=torch.int64, device=dev)
        i = sum(k[0] == dev for k in _gate_rows)
        if i >= GATE_ROWS:
            raise RuntimeError(f"more than {GATE_ROWS} gate counters on "
                               f"{dev}")
        _gate_rows[key] = i
    return _gate_tables[dev][i]


def gate(name: str, pred: torch.Tensor, body: Callable, leaves,
         branch: bool = True):
    """``body(leaves)``, a stage whose writes are masked by the 0-d bool
    ``pred``; inside a ``run`` capture, with ``branch``, an IF node on
    ``pred`` whose body writes the new leaves into ``leaves``' storage
    (see the notes above).  Counted in ``gate_stats`` under ``name`` (not
    under vmap)."""
    ctx = getattr(_local, "gates", None)
    if ctx is None or not branch or is_batched(pred):
        if not is_batched(pred):
            row = _row(pred.device, name, ())
            row[0].add_(1)
            row[1].add_(pred.reshape(()))
        return body(leaves)
    return _branch(ctx, name, pred, body, leaves)


def _branch(ctx: _Gates, name: str, pred: torch.Tensor, body: Callable,
            leaves):
    import ctypes
    from rpg_svo_tpu_torch.ops import cuda_build
    if pred.dtype is not torch.bool or pred.numel() != 1:
        raise ValueError(f"gate {name!r}: the predicate must be one bool, "
                         f"not {pred.dtype} {tuple(pred.shape)}")
    dev = pred.device
    pred = pred.reshape(()).contiguous()
    open_ = cuda_build.function(
        "gate_open", (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p),
        "graph_gate")
    close = cuda_build.function("gate_close", (ctypes.c_void_p,),
                                "graph_gate")
    cuda_build.check(open_(torch.cuda.current_stream(dev).cuda_stream,
                           pred.data_ptr(), ctx.stream.cuda_stream),
                     f"gate {name!r}: gate_open")
    launches: dict = {}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        # a conditional body may hold no event node: span boundaries in
        # it record nothing
        with torch.cuda.stream(ctx.stream), _recording(launches), \
                _gating(None), spans.capturing(None):
            # the body's tensors go to the gates' pool (the graph's own
            # pool takes only the capturing stream's allocations)
            torch._C._cuda_beginAllocateCurrentThreadToPool(idx, ctx.pool.id)
            try:
                write_back(leaves, body(leaves))
                row = _row(dev, name, tuple(sorted(launches.items())))
                row[1].add_(1)
            finally:
                torch._C._cuda_endAllocateToPool(idx, ctx.pool.id)
                torch._C._cuda_releasePool(idx, ctx.pool.id)
    finally:
        err = close(ctx.stream.cuda_stream)
    cuda_build.check(err, f"gate {name!r}: gate_close")
    row[0].add_(1)
    return leaves


def write_back(state, new) -> None:
    """Every leaf of ``new`` into the storage of the same leaf of
    ``state`` (a leaf already there is left alone); a leaf of another
    shape or dtype, or one in the storage of another leaf of ``state``,
    raises."""
    olds, spec = pytree.tree_flatten(state)
    news, nspec = pytree.tree_flatten(new)
    if nspec != spec:
        raise ValueError(f"a donated state came back as {nspec}")
    at: dict = {}
    for i, x in enumerate(olds):
        at.setdefault(x.data_ptr(), set()).add(i)
    for i, (old, now) in enumerate(zip(olds, news)):
        if now.shape != old.shape or now.dtype != old.dtype:
            raise ValueError(f"a donated leaf {tuple(old.shape)} {old.dtype}"
                             f" came back {tuple(now.shape)} {now.dtype}")
        here = at.get(now.data_ptr())
        if here is None:
            old.copy_(now)
        elif i not in here:
            raise ValueError(f"leaf {i} came back in the storage of leaves "
                             f"{sorted(here)}")


def gate_stats() -> dict:
    """Per gate name: ``reached``, the steps and replays that reached the
    gate, and ``ran``, those on which its body ran (on a graph replay) or
    its predicate held (eager), since ``reset_jit_counts``.  Reads the
    counters from the card."""
    counts = {dev: t.tolist() for dev, t in _gate_tables.items()}
    out: dict = {}
    for (dev, name, _), i in _gate_rows.items():
        d = out.setdefault(name, {"reached": 0, "ran": 0})
        d["reached"] += counts[dev][i][0]
        d["ran"] += counts[dev][i][1]
    return out


class Jitted:
    """A function wrapped by ``jit``; calling it calls the function (see
    the module's notes for when that is a graph replay)."""

    def __init__(self, fn: Callable, static_argnames=()):
        if isinstance(static_argnames, str):
            static_argnames = (static_argnames,)
        self.fn = fn
        self.static_argnames = tuple(static_argnames)
        self.signature = inspect.signature(fn)
        missing = [n for n in self.static_argnames
                   if n not in self.signature.parameters]
        if missing:
            raise ValueError(f"graphed.jit({fn.__qualname__}): no "
                             f"parameter {missing}")
        functools.update_wrapper(self, fn)
        self._graphs: "OrderedDict[tuple, _StageGraph]" = OrderedDict()
        self.captures = self.replays = self.evictions = 0
        self.in_copied_mb = self.out_copied_mb = 0.0
        _jitted.append(self)

    def _split(self, args, kwargs):
        """(bound arguments, static items, tensor leaves, the structure
        and the other leaves, a rebuild of (args, kwargs) around new
        tensor leaves)."""
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        arguments = bound.arguments
        static = tuple((n, arguments[n]) for n in self.static_argnames)
        leaves, spec = pytree.tree_flatten(
            {n: v for n, v in arguments.items()
             if n not in self.static_argnames})
        pos = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        rest = (spec, [(i, x) for i, x in enumerate(leaves)
                       if not isinstance(x, torch.Tensor)])

        def rebuild(tensors):
            full = list(leaves)
            for i, t in zip(pos, tensors):
                full[i] = t
            new = dict(pytree.tree_unflatten(full, spec), **dict(static))
            b = inspect.BoundArguments(self.signature, OrderedDict(
                (n, new[n]) for n in arguments))
            return b.args, b.kwargs
        return arguments, static, [leaves[i] for i in pos], rest, rebuild

    def key(self, *args, **kwargs) -> tuple:
        """The key of the graph a call with these arguments replays."""
        _, static, tensors, rest, _ = self._split(args, kwargs)
        return self._key(static, tensors, rest)

    @staticmethod
    def _key(static, tensors, rest) -> tuple:
        spec, values = rest
        return (tuple((n, _static_key(v)) for n, v in static),
                spec, tuple((i, _key_leaf(x)) for i, x in values),
                tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                      for t in tensors), ambient_mesh())

    def __call__(self, *args, **kwargs):
        if _flag("disabled") or _flag("tracing"):
            return self.fn(*args, **kwargs)
        arguments, static, tensors, rest, rebuild = self._split(args, kwargs)
        if not _jit_on_card(tensors):
            return self.fn(*args, **kwargs)
        if arguments.get("inplace"):
            raise ValueError(f"{self.__qualname__}: an in-place call cannot "
                             f"replay a functional graph")
        # the input buffers are shared: one call at a time copies into them
        # and replays (a thread feeding frames may call a renderer)
        with _call_lock:
            if spans.ON:
                with spans.span("jit." + self.__qualname__, None, None):
                    return self._replay(tensors, rebuild,
                                        self._key(static, tensors, rest))
            return self._replay(tensors, rebuild,
                                self._key(static, tensors, rest))

    def _replay(self, tensors: list, rebuild, key: tuple):
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(tensors, rebuild)
            self.captures += 1
            while len(self._graphs) > JIT_MAX:
                self._graphs.popitem(last=False)
                self.evictions += 1
        else:
            self._graphs.move_to_end(key)
            _copy_leaves(g.inputs, tensors)
        self.in_copied_mb += g.in_mb
        _replay_graph(g.graph, g.launches, tensors[0].device)
        self.replays += 1
        out, fresh, srcs = [], [], []
        for kind, v in g.outs:
            if kind == "copy":
                out.append(torch.empty_like(v))
                fresh.append(out[-1])
                srcs.append(v)
            else:
                out.append(tensors[v] if kind == "input" else v)
        _copy_leaves(fresh, srcs)
        self.out_copied_mb += _mb(fresh)
        return pytree.tree_unflatten(out, g.spec)

    def _capture(self, tensors: list, rebuild) -> _StageGraph:
        """The graph of one key, its input buffers holding ``tensors``.
        Raises if the body writes one of its inputs in place: a replay
        would write the buffer, not the caller's tensor."""
        bufs = _shared_buffers(tensors)
        _copy_leaves(bufs, tensors)
        args, kwargs = rebuild(bufs)
        versions = [b._version for b in bufs]
        c = _capture_graph(self.fn, args, kwargs, tensors[0].device)
        written = [i for i, (b, v) in enumerate(zip(bufs, versions))
                   if b._version != v]
        if written:
            raise ValueError(f"graphed.jit({self.__qualname__}): the body "
                             f"writes its tensor arguments {written} (in "
                             f"leaf order) in place; a functional graph "
                             f"cannot")
        leaves, spec = pytree.tree_flatten(c.out)
        ids = {id(b): i for i, b in enumerate(bufs)}
        outs = [("input", ids[id(x)]) if id(x) in ids
                else ("copy", x) if isinstance(x, torch.Tensor)
                else ("const", x) for x in leaves]
        return _StageGraph(c.graph, bufs, (args, kwargs), spec, outs,
                           c.launches, c.capture_s, _mb(bufs), c.pool_mb)

    def clear(self) -> None:
        """Drop this function's graphs (and their memory pools)."""
        self._graphs.clear()

    def stats(self) -> dict:
        gs = list(self._graphs.values())
        return dict(captures=self.captures, replays=self.replays,
                    evictions=self.evictions, graphs=len(gs),
                    in_copied_mb=self.in_copied_mb,
                    out_copied_mb=self.out_copied_mb,
                    in_mb=sum(g.in_mb for g in gs),
                    pool_mb=sum(g.pool_mb for g in gs),
                    capture_s=sum(g.capture_s for g in gs))


_jitted: list = []


def jit(fn: Callable | None = None, *, static_argnames=()):
    """``jax.jit`` for the port: ``jit(f, static_argnames=(...))`` or
    ``@jit(static_argnames=(...))``; the static names are the JAX
    decorator's."""
    if fn is None:
        return functools.partial(jit, static_argnames=static_argnames)
    return Jitted(fn, static_argnames)


def jit_stats() -> dict:
    """Per wrapped function (module.qualname): captures, replays,
    evictions, MB copied in and out, and of the graphs kept their count,
    the MB of the (shared) input buffers they read, pool MB and capture
    seconds."""
    return {f"{f.__module__}.{f.__qualname__}": f.stats() for f in _jitted}


def reset_jit_counts() -> None:
    """Zero every function's capture, replay, eviction and copy counts,
    the graph replays' kernel launches, the slots' copy counts and the
    gate counters (on the card's stream, no wait)."""
    _replayed.clear()
    _kept.update(in_copied_mb=0.0, out_copied_mb=0.0)
    for t in _gate_tables.values():
        t.zero_()
    for f in _jitted:
        f.captures = f.replays = f.evictions = 0
        f.in_copied_mb = f.out_copied_mb = 0.0
