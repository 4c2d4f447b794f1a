"""What a ``--trace 1`` run records, for the per-layer readers in
``metrics/``.

- The window itself: the handler's own per-frame records (its SVO_TRACE
  stage timers), the stage graphs' counters (``graphed.jit_stats``) and
  the host's waits on the card, counted over the whole window by CUDA's
  sync debug mode (each attributed to the line of the program that
  caused it, as ``chip_smoke._host_syncs`` does; the harness's own read of
  each result is not the program's and is not counted).
- After it closes, the stream goes on under ``torch.profiler``: first
  ``GRID_STEPS`` steps whose chrome trace gives K1's launch grids (K1's
  roofline); then, unprofiled, up to a keyframe, and from the step after
  it to the same stream's next keyframe, profiled in runs of
  ``CHUNK_STEPS`` steps, so that the segment holds tracking and
  keyframe frames in the share the stream makes them.  The chunks keep
  each profile's buffers small (the profiler records each of a graph's
  ~9k kernels); their wall times add up to the segment's, which the
  busy share divides by.  The profiler's records stretch a graph replay,
  so the segment runs slower than the window.
"""

from __future__ import annotations

import heapq
import json
import sys
import time
import warnings
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Optional

import torch

from svo_bench import stats

GRID_STEPS = 4          # even: the handler's seed update runs every 2nd frame
CHUNK_STEPS = 24
MAX_STEPS = 400         # the profiled segment's most steps
PORT = "rpg_svo_tpu_torch"
K1 = "tile_gather_kernel"
# where a traced run writes the profiler's trace when it needs the launch
# grids from it (inside the checkout, overwritten by every such run)
TRACE_FILE = Path(__file__).resolve().parent.parent / "build" \
    / "svo_bench_cache" / "profile.json"


def _source_line() -> Optional[str]:
    """The innermost line of the program on the current stack."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if PORT in name:
            return f"{name.split(PORT)[-1]}:{f.f_lineno}"
        f = f.f_back
    return None


class Recorder:
    """Runs the instruments and keeps what they read."""

    def __init__(self, streams: int, device):
        self.streams = streams
        self.device = device
        self.grids = None
        self.chunks = []
        self.syncs = None

    @contextmanager
    def count_syncs(self):
        """CUDA's sync debug mode over the block: the program's waits on
        the card and their source lines (``syncs``)."""
        found = []

        def note_sync(message, *_args, **_kw):
            if "called a synchronizing" in str(message):
                found.append(_source_line())

        cuda = self.device.type == "cuda"
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note_sync
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
        here = [s for s in found if s]
        self.syncs = {"count": len(here), "sources": sorted(set(here))}

    def profile(self, step: Callable) -> None:
        """The profiled segments after the window; ``step()`` steps every
        stream once and returns its ``Result``."""
        if self.device.type != "cuda":
            return
        self.grids = self._profile(step, GRID_STEPS, export=True)
        for _ in range(MAX_STEPS):
            kf = step().keyframe
            if kf.any():
                break
        else:
            return
        b = int(kf.argmax())
        left = MAX_STEPS
        while left > 0:
            chunk = self._profile(step, min(CHUNK_STEPS, left), until=b)
            self.chunks.append(chunk)
            left -= chunk["steps"]
            if chunk["closed"]:
                break

    def _profile(self, step, n: int, until: Optional[int] = None,
                 export: bool = False) -> dict:
        """``n`` steps under the profiler, or fewer, up to the first in
        which stream ``until`` makes a keyframe."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        closed = False
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for i in range(n):
                r = step()
                if until is not None and r.keyframe[until]:
                    closed = True
                    break
            torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t
        dev, host = [], []
        n_aten = 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.name(), e.start_ns(), e.duration_ns(), None))
            else:
                host.append((e.name(), e.start_ns(), e.end_ns()))
                n_aten += e.name().startswith("aten::")
        if export:
            dev = _k1_grids(prof, dev)
        return {"device": dev, "host": host, "host_aten": n_aten,
                "steps": i + 1, "frames": (i + 1) * self.streams,
                "wall_s": wall, "closed": closed}

    def record(self, **window) -> dict:
        """The readers' view: the window's figures (``kind``, ``frames``,
        ``window_s``, ``spans``, ``jit``), the sync count over the window
        (``syncs``: the program's waits, their source lines), the grid
        segment (``grids``: device events (name, start ns, duration ns,
        launch grid)) and the keyframe interval (``profile``: its chunks'
        device events, host events (name, start ns, end ns) and wall
        seconds, and in all: host aten ops, frames, wall seconds)."""
        prof = None
        if self.chunks:
            prof = {"chunks": [{"device": c["device"], "host": c["host"],
                                "wall_s": c["wall_s"]} for c in self.chunks],
                    "host_aten": sum(c["host_aten"] for c in self.chunks),
                    "frames": sum(c["frames"] for c in self.chunks),
                    "wall_s": sum(c["wall_s"] for c in self.chunks),
                    "closed": self.chunks[-1]["closed"]}
        return dict(window, syncs=self.syncs, grids=self.grids,
                    profile=prof)

    def device_times(self) -> dict:
        """``busy_s`` (the union of the keyframe interval's device events,
        chunk by chunk) and ``window_s`` (its chunks' wall time)."""
        if not self.chunks or not any(c["device"] for c in self.chunks):
            return {}
        return {"busy_s": sum(busy_s(c["device"]) for c in self.chunks),
                "window_s": sum(c["wall_s"] for c in self.chunks)}

    def breakdown(self) -> Optional[dict]:
        """The ten device ops of the keyframe interval that took most
        time, and its ten longest idle gaps by the host event running
        across them."""
        if not self.chunks:
            return None
        by = defaultdict(float)
        gaps = defaultdict(float)
        for c in self.chunks:
            for name, _, dur, _ in c["device"]:
                by[name] += dur / 1e9
            for name, s in idle_gaps(c["device"], c["host"]):
                gaps[name] += s
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in sorted(
                    gaps.items(), key=lambda kv: -kv[1])][:10]}


def _k1_grids(prof, dev: list) -> list:
    """``dev`` with each K1 event's launch grid, which only the profiler's
    chrome trace carries (the kernels' ``args.grid``), matched in start
    order; without a grid for every K1 event, none."""
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_FILE))
    with open(TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    TRACE_FILE.unlink()
    grids = [e["args"].get("grid") for e in sorted(
        (e for e in events if e.get("cat") == "kernel"
         and K1 in e.get("name", "")), key=lambda e: e["ts"])]
    k1 = sorted((i for i, d in enumerate(dev) if K1 in d[0]),
                key=lambda i: dev[i][1])
    if len(grids) != len(k1):
        return dev
    out = list(dev)
    for i, g in zip(k1, grids):
        out[i] = out[i][:3] + (g,)
    return out


def busy_s(device_events) -> float:
    """Seconds in which at least one device op ran."""
    return stats.covered((s / 1e9, (s + d) / 1e9)
                         for _, s, d, _ in device_events)


def idle_gaps(device_events, host_events, short_ns: float = 10e3) -> list:
    """[[what the host was doing, idle seconds], ...] longest first: each
    gap between device ops of at least ``short_ns`` is named by the
    shortest host event that spans its middle; shorter gaps (the card's
    own pace between the kernels of a graph) are summed as one entry."""
    busy = stats.merge((s, s + d) for _, s, d, _ in device_events)
    by = defaultdict(float)
    mids = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 - e0 < short_ns:
            by[f"gaps under {short_ns / 1e3:g} us"] += (s1 - e0) / 1e9
        else:
            mids.append(((e0 + s1) / 2, (s1 - e0) / 1e9))
    # a sweep over the gaps' middles in time order: the host events begun
    # by then, shortest first; one that has ended is done for every later
    # middle too
    host = sorted(host_events, key=lambda h: h[1])
    heap, i = [], 0
    for mid, gap in sorted(mids):
        while i < len(host) and host[i][1] <= mid:
            name, s, e = host[i]
            heapq.heappush(heap, (e - s, e, i, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        by[heap[0][3] if heap else "host outside any recorded op"] += gap
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])]
