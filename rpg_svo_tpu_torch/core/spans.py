"""Program spans: named intervals on the host and on the card, recorded at
the port's layer boundaries, off by default.

Port-only: the counterpart of the reference's SVO_TRACE stage timers
(vk::PerformanceMonitor, frame_handler_base.cpp:46-74), which a build
flag leaves out unless asked for.  One process-wide switch, ``ON``, is
read at every boundary::

    with spans.recording():
        ...                         # the program runs and keeps its spans
    spans.summary()

While it is off a boundary costs the read of ``ON`` and nothing more: no
CUDA event, no profiler range, no Python object and no wait.

A span has a name, its parent (the span open around it, -1 for a root),
the id of its frame (shared by every span under one root: an
``add_image`` call, a graphed step) and up to two intervals in
nanoseconds on the clock of the profiler's host events
(``time.time_ns``):

- ``host``: the host's clock at its boundaries, for a span the host runs
  through (none for the stages inside a CUDA graph);
- ``device``: for a span on a card, ``torch.cuda.Event`` s recorded on
  the current stream at its boundaries: the stream's time, which counts
  the card's idle gaps inside the span.  One anchor event per card,
  recorded at a host-stamped moment with the card idle, puts them on the
  host's clock.  A frame's spans are read together once its last event
  has completed (``query()``), at the next root span or at ``flush()``,
  each event's time taken against the frame's first; nothing but
  ``flush`` and ``clear`` waits.

Inside a CUDA graph capture that ``graphed.run`` makes, a boundary records
an event made with ``external=True``, which becomes a node of the graph
(``capturing``); every replay records it again, and ``replay`` makes that
replay's spans of them, read before the graph's next replay (a replay
whose events are not complete by then is dropped, and counted).  Inside
any other capture boundaries record nothing.  While ``torch.profiler``
runs, a span is also a profiler range named ``svo.<name>``: a CPU op
(``_RecordFunctionFast``), which, unlike ``record_function``'s user
annotation, puts no event of its own on the card's timeline.

A root span may carry a ``sink``, a dict (``add_image``'s info) into
which every span of its frame adds its seconds under its name once read:
the device's where it has them, else the host's.

Spans are kept in a bounded buffer (``MAX_SPANS``, oldest out first),
read by ``recorded()`` and ``summary()``, emptied by ``clear()``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

ON = False
MAX_SPANS = 1 << 18
MAX_FREE = 1 << 10              # timing events kept for reuse, per card
PREFIX = "svo."
_INHERIT = object()


class Span(NamedTuple):
    id: int
    name: str
    parent: int                 # the id of the span around it, -1 if none
    frame: int
    host: Optional[Tuple[int, int]]     # (start, end) ns, time.time_ns
    device: Optional[Tuple[int, int]]   # the stream's, on the same clock


class _Open:
    """A span not yet read: open, or closed with events in flight."""
    __slots__ = ("id", "name", "parent", "frame", "device", "sink", "h0",
                 "h1", "e0", "e1", "rf")


class _Frame:
    """A frame's closed spans; ``first`` and ``last`` its first and last
    events, on card ``idx``."""
    __slots__ = ("spans", "first", "last", "idx")

    def __init__(self):
        self.spans, self.first, self.last, self.idx = [], None, None, None


_buffer: deque = deque(maxlen=MAX_SPANS)
_open_frames: dict = {}         # frame id -> _Frame whose root is open
_pending: list = []             # closed _Frames whose events are not read
_replaying: dict = {}           # id -> Marks whose last replay is not read
_anchors: dict = {}             # card index -> (event, host ns)
_free: dict = {}                # card index -> timing events to reuse
_streams: dict = {}             # card index -> its last current stream
_ids = itertools.count()
_frames = itertools.count()
_dropped = [0]
_lock = threading.Lock()
_local = threading.local()


@contextlib.contextmanager
def recording():
    """Spans on inside the block; ``flush()`` when it ends."""
    global ON
    prev, ON = ON, True
    try:
        yield
    finally:
        flush()
        ON = prev


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _anchor(idx: int) -> None:
    torch.cuda.synchronize(idx)
    ev = torch.cuda.Event(enable_timing=True)
    t = time.time_ns()
    ev.record(torch.cuda.current_stream(idx))
    ev.synchronize()
    _anchors[idx] = (ev, t)
    _free.setdefault(idx, [])


def _event(device: Optional[torch.device]):
    """A timing event recorded now on the card's current stream; None
    off a card (or for a host span, ``device`` None)."""
    if device is None or device.type != "cuda":
        return None
    idx = _index(device)
    if idx not in _anchors:
        _anchor(idx)
    free = _free[idx]
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(_stream(idx))
    return ev


def _stream(idx: int):
    """The card's current stream, its Python object made anew only when
    the raw stream changed (making one costs more than the record)."""
    s = _streams.get(idx)
    if s is None or s.cuda_stream != torch._C._cuda_getCurrentRawStream(idx):
        s = _streams[idx] = torch.cuda.current_stream(idx)
    return s


def _open(name: str, device, sink, t: int, ev) -> None:
    stack = _stack()
    s = _Open()
    if stack:
        top = stack[-1]
        s.parent, s.frame = top.id, top.frame
        s.sink = top.sink if sink is _INHERIT else sink
    else:
        s.parent, s.frame = -1, next(_frames)
        s.sink = None if sink is _INHERIT else sink
        _resolve()
        _open_frames[s.frame] = _Frame()
    f = _open_frames[s.frame]
    if ev is not None and f.first is None:
        f.first, f.idx = ev, _index(device)
    s.id, s.name, s.device, s.h0, s.e0, s.h1, s.e1 = \
        next(_ids), name, device, t, ev, None, None
    s.rf = None
    if _profiler._is_profiler_enabled:
        s.rf = _RecordFunctionFast(PREFIX + name)
        s.rf.__enter__()
    stack.append(s)


def _close(s: _Open, t: int, ev) -> None:
    s.h1, s.e1 = t, (None if s.e0 is None else ev)
    if s.rf is not None:
        s.rf.__exit__(None, None, None)
    f = _open_frames[s.frame]
    f.spans.append(s)
    if s.e1 is not None:
        f.last = s.e1
    if s.parent == -1:
        del _open_frames[s.frame]
        if f.last is None:
            for x in f.spans:
                _keep(x, None)
        else:
            with _lock:
                _pending.append(f)


def begin(name: str, device: Optional[torch.device],
          sink=_INHERIT) -> None:
    """Open a span inside the innermost open one (a root if none is), on
    ``device`` (None: a host span, with no events).  ``sink``: a dict for
    the frame's seconds by name (a root's own, or None for none), else the
    parent's."""
    cap = getattr(_local, "capture", None)
    if cap is not None:
        cap.begin(name)
        return
    _open(name, device, sink, time.time_ns(), _event(device))


def end(n: int = 1) -> None:
    """Close the ``n`` innermost open spans, at one moment."""
    cap = getattr(_local, "capture", None)
    if cap is not None:
        cap.end(n)
        return
    stack = _stack()
    t = time.time_ns()
    if n == 1:
        ev = _event(stack[-1].device if stack[-1].e0 is not None else None)
    else:
        ev = _event(next((s.device for s in stack[-n:]
                          if s.e0 is not None), None))
    for _ in range(n):
        _close(stack.pop(), t, ev)


def switch(name: str, device: torch.device) -> None:
    """Close the innermost open span and open ``name`` in its place, at
    one boundary (one event)."""
    cap = getattr(_local, "capture", None)
    if cap is not None:
        cap.switch(name)
        return
    stack = _stack()
    t, ev = time.time_ns(), _event(device)
    _close(stack.pop(), t, ev)
    _open(name, device, _INHERIT, t, ev)


class span:
    """``with span(name, device[, sink]):`` a span around the block; spans
    the block left open are closed with it (an exception inside a
    stage).  A class, not a generator: it is entered on every graphed
    call while spans are on."""
    __slots__ = ("args", "depth")

    def __init__(self, name: str, device: Optional[torch.device],
                 sink=_INHERIT):
        self.args = (name, device, sink)

    def __enter__(self):
        self.depth = len(_stack())
        begin(*self.args)

    def __exit__(self, *exc):
        end(max(1, len(_stack()) - self.depth))


def _clock(idx: int, first):
    """ns on the host clock of events of one frame (or replay) on card
    ``idx`` that begins with ``first``: one ``elapsed_time`` an event,
    each against ``first`` (a frame's milliseconds keep float32's
    precision), ``first`` once against the anchor."""
    anchor, t = _anchors[idx]
    base = t + round(anchor.elapsed_time(first) * 1e6)
    seen = {id(first): base}

    def at(ev) -> int:
        k = id(ev)
        if k not in seen:
            seen[k] = base + round(first.elapsed_time(ev) * 1e6)
        return seen[k]
    return at


def _keep(s: _Open, dev) -> None:
    host = None if s.h0 is None else (s.h0, s.h1)
    _buffer.append(Span(s.id, s.name, s.parent, s.frame, host, dev))
    if s.sink is not None:
        d = dev if dev is not None else host
        s.sink[s.name] = s.sink.get(s.name, 0.0) + (d[1] - d[0]) / 1e9


def _resolve() -> None:
    """Read every closed frame whose last event has completed (its
    earlier ones have: they precede it on the stream, or on a side stream
    it waited for)."""
    with _lock:
        done, left = [], []
        for f in _pending:
            (done if f.last.query() else left).append(f)
        _pending[:] = left
    for f in done:
        at = _clock(f.idx, f.first)
        events = {}
        for s in f.spans:
            if s.e0 is None:
                _keep(s, None)
            else:
                _keep(s, (at(s.e0), at(s.e1)))
                events[id(s.e0)], events[id(s.e1)] = s.e0, s.e1
        free = _free[f.idx]
        if len(free) < MAX_FREE:
            free.extend(events.values())


class Marks:
    """The boundaries captured into one CUDA graph: their events (nodes of
    the graph) and the spans they bound, as (name, parent index, start
    event, end event); ``last`` is the replay not yet read, as (parent
    span id, frame)."""

    def __init__(self, device: torch.device):
        self.idx = _index(device)
        self.events: list = []
        self.spans: list = []
        self._open: list = []
        self.last = None

    def _mark(self) -> int:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record(torch.cuda.current_stream(self.idx))
        self.events.append(ev)
        return len(self.events) - 1

    def _begin(self, name: str, i: int) -> None:
        self.spans.append([name, self._open[-1] if self._open else -1, i,
                           None])
        self._open.append(len(self.spans) - 1)

    def _end(self, n: int, i: int) -> None:
        for _ in range(n):
            self.spans[self._open.pop()][3] = i

    def begin(self, name: str) -> None:
        self._begin(name, self._mark())

    def end(self, n: int) -> None:
        self._end(n, self._mark())

    def switch(self, name: str) -> None:
        i = self._mark()
        self._end(1, i)
        self._begin(name, i)


class _Ignore:
    """A capture whose graph keeps no boundary (a ``graphed.jit`` stage)."""

    def begin(self, name):
        pass

    def end(self, n):
        pass

    def switch(self, name):
        pass


@contextlib.contextmanager
def capturing(marks: Optional[Marks]):
    """Boundaries inside the block go into ``marks`` (None: nowhere), not
    onto the live spans."""
    prev = getattr(_local, "capture", None)
    _local.capture = _Ignore() if marks is None else marks
    try:
        yield
    finally:
        _local.capture = prev


def replay(graph, device: torch.device, marks: Optional[Marks]) -> None:
    """``graph.replay()`` inside a span ``replay`` on ``device``; with
    ``marks`` (the graph's boundaries), the replay's stage spans under it,
    read from the graph's events later.  The last replay's are read first,
    before this one records the events anew; if they are not complete,
    that replay's stage spans are dropped."""
    if marks is not None and marks.last is not None:
        _read_replay(marks)
    begin("replay", device, None)
    graph.replay()
    if marks is not None:
        top = _stack()[-1]
        marks.last = (top.id, top.frame)
        _replaying[id(marks)] = marks
    end()


def _read_replay(marks: Marks) -> None:
    parent, frame = marks.last
    marks.last = None
    _replaying.pop(id(marks), None)
    ev = marks.events
    if not ev[-1].query():
        _dropped[0] += 1
        return
    at = _clock(marks.idx, ev[0])
    ids = [next(_ids) for _ in marks.spans]
    for k, (name, up, i0, i1) in enumerate(marks.spans):
        _buffer.append(Span(ids[k], name, ids[up] if up >= 0 else parent,
                            frame, None, (at(ev[i0]), at(ev[i1]))))


def flush() -> None:
    """Wait for every card spans were recorded on, then read every span
    and replay not yet read."""
    for idx in _anchors:
        torch.cuda.synchronize(idx)
    _resolve()
    for marks in list(_replaying.values()):
        _read_replay(marks)


def clear() -> None:
    """``flush()``, then empty the buffer, zero the dropped count and
    anchor each card anew (the clock's reading stays fine over a window
    that starts here)."""
    flush()
    _buffer.clear()
    _dropped[0] = 0
    for idx in list(_anchors):
        _anchor(idx)


def recorded() -> list:
    """The spans kept, in the order they were read."""
    return list(_buffer)


def dropped() -> int:
    """Graph replays whose spans were dropped since ``clear()``."""
    return _dropped[0]


def _covered(intervals, within) -> int:
    """ns of ``within`` that the union of ``intervals`` covers."""
    lo, hi = within
    out, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            out += e - s
            end = e
    return out


def _quantiles(values: list) -> list:
    """[min, 5%, 50%, 95%, max] of the values, nearest rank."""
    v = sorted(values)
    return [v[min(len(v) - 1, int(q * len(v)))] for q in
            (0.0, 0.05, 0.5, 0.95)] + [v[-1]]


def summary(spans: Optional[list] = None) -> dict:
    """Per name over the spans (the kept ones by default): how many,
    host seconds, host self seconds (less what its children's host
    intervals cover), device seconds and [min, 5%, 50%, 95%, max] of the
    device ms of one span; the number of frames, and of replays
    dropped."""
    spans = recorded() if spans is None else spans
    kids: dict = {}
    for s in spans:
        if s.host is not None and s.parent >= 0:
            kids.setdefault(s.parent, []).append(s.host)
    by: dict = {}
    dev: dict = {}
    for s in spans:
        d = by.setdefault(s.name, {"n": 0, "host_s": 0.0,
                                   "host_self_s": 0.0, "device_s": 0.0})
        d["n"] += 1
        if s.host is not None:
            h = s.host[1] - s.host[0]
            d["host_s"] += h / 1e9
            d["host_self_s"] += (h - _covered(kids.get(s.id, ()),
                                              s.host)) / 1e9
        if s.device is not None:
            ns = s.device[1] - s.device[0]
            d["device_s"] += ns / 1e9
            dev.setdefault(s.name, []).append(ns / 1e6)
    for name, ms in dev.items():
        by[name]["device_ms"] = _quantiles(ms)
    return {"frames": len({s.frame for s in spans}), "dropped": dropped(),
            "by_name": by}
