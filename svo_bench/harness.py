"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic in ``traffic/<traffic>.json`` (which names a path in
``paths/<path>.json`` and an entry in ``entries/<entry>.py``), its limits
in ``limits/<cell>.json`` and each per-layer metric in
``metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from svo_bench import compare, scene, stats, trace as tracing

HERE = Path(__file__).resolve().parent
# modules that must not be loaded in the process that prints the result,
# compared by whole top-level names (the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "rpg_svo_tpu")
# the control's chain of reference steps: at most this many frames
CHAIN_FRAMES = 600


def log(msg: str) -> None:
    print(f"[svo_bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Ctx(NamedTuple):
    """What an entry adapter is built from."""
    cfg_file: dict
    img_shape: tuple
    streams: int
    device: torch.device


class Cell(NamedTuple):
    name: str
    cfg_file: dict
    traffic: dict
    path: dict
    limits: Optional[dict]
    per_layer: list          # this cell's per-layer metrics (BENCHMARK.json)
    end_to_end: list


def load_cell(name: str, bench: dict, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` with its files under ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    lim = root / "limits" / f"{name}.json"

    def here(m):
        return "workloads" not in m or name in m["workloads"]
    return Cell(name, load_json(root / "configs" / f"{w['config']}.json"),
                traffic, load_json(root / "paths" / f"{traffic['path']}.json"),
                load_json(lim) if lim.exists() else None,
                [m for m in bench["per_layer"] if here(m)],
                [m for m in bench["end_to_end"] if here(m)])


def load_entry(name: str):
    return importlib.import_module(f"svo_bench.entries.{name}")


def load_metric(name: str):
    """The reader module of one per-layer metric (``metrics/<name>.py``;
    the file name is the metric's name, dots included)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "svo_bench.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if mod.NAME != name:
        raise ValueError(f"{path} declares {mod.NAME!r}")
    return mod


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Sample(NamedTuple):
    frames: list             # the lap index of each stream's frame
    streams: list            # the streams the check compares
    before: dict             # {stream: held state before the step}
    after: dict              # and after it
    result: object           # the step's Result


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, trace: bool, bench: dict,
        device: torch.device, t_start: float, root: Path = HERE,
        control: bool = False) -> tuple:
    """One run: (the result line's object, the run's log: the largest
    position error against ground truth, the set-up's capture seconds,
    captures in the window, keyframes, the samples and every reading of
    the check, forbidden modules found)."""
    cell = load_cell(workload, bench, root)
    cfg_file, traffic, path = cell.cfg_file, cell.traffic, cell.path
    B = int(traffic["streams"])
    img_shape = tuple(cfg_file["img_shape"])
    mod = load_entry(traffic["entry"])
    if device.type == "cuda":
        from rpg_svo_tpu_torch.ops import cuda_build
        cuda_build.build()
    from rpg_svo_tpu_torch.core import graphed

    # -- the scene, rendered once ------------------------------------------
    c = cfg_file["camera"]
    cam = scene.Camera(c["width"], c["height"], c["fx"], c["fy"], c["cx"],
                       c["cy"])
    lap = scene.circle_path(path)
    P = len(lap.t_wc)
    frames = scene.render_lap(cam, scene.texture(seed, **path["texture"]),
                              lap, device)
    starts = [b * P // B for b in range(B)]
    depths = [scene.depth_map(cam, lap, s, device) for s in starts]
    log(f"{workload}: {P} frames per lap rendered, {B} stream(s), "
        f"{frames.nbytes / 2**20:.0f} MiB of uint8 frames")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    # -- seeding and warm-up (set-up): every stream's map filled to its
    # cap (max_n_kfs keyframes inserted, so at least one deleted), on the
    # stream that the window continues ------------------------------------
    entry = mod.Entry(Ctx(cfg_file, img_shape, B, device))
    entry.seed([frames[s] for s in starts], lap.R_wc[starts],
               lap.t_wc[starts], depths)
    kept_start = entry.hold(entry.keep(), range(B))
    del depths
    cap = int(cfg_file["settings"]["max_n_kfs"])
    pos = [s + 1 for s in starts]
    n_warm = 0
    kfs = np.zeros(B, np.int64)
    while not (kfs.min() >= cap and entry.warm(n_warm, int(kfs.min()))):
        r = entry.step([frames[p % P] for p in pos])
        pos = [p + 1 for p in pos]
        n_warm += 1
        kfs += r.keyframe
        if r.failed.any():
            raise RuntimeError(f"tracking failed in the warm-up, frame "
                               f"{n_warm}")
        if n_warm > 2 * P:
            raise RuntimeError("the warm-up did not fill the map in two "
                               "laps")
    _sync(device)
    jit0 = graphed.jit_stats()
    log(f"{workload}: warm after {n_warm} step(s), {kfs.tolist()} "
        f"keyframe(s)")
    # the copies the window's samples hold (each sample keeps the state
    # before and after its step, of the streams a sample drawn from the
    # seed takes), made once here and let go: the window's copies then
    # take memory the allocator or the entry already holds, and the host
    # makes no device allocation between two steps
    n_hold = 2 * (int(traffic["samples"]) + int(traffic["keyframe_samples"]))
    per_hold = -(-B // max(1, int(traffic["samples"])))
    pre = [entry.keep() for _ in range(n_hold)]
    held = [entry.hold(k, range(per_hold)) for k in pre]
    del held
    for k in pre:
        entry.release(k)
    del pre
    _sync(device)
    chain_start = entry.hold(entry.keep(), [0]) if control else None
    chain_frames = []

    # -- the window: every keyframe frame is a sample (up to the mix's
    # number, each taken with its share), and frames at times drawn from
    # the seed ------------------------------------------------------------
    rng = random.Random(seed)
    n_rand = int(traffic["samples"])
    kf_cap = int(traffic["keyframe_samples"])
    kf_share = float(traffic["keyframe_share"])
    sample_at = sorted(rng.uniform(0.05, 0.95) * seconds
                       for _ in range(n_rand))
    samples = []
    k_rand = n_kf_samples = 0
    lat, spans, gt_err, gt_jump = [], [], [], []
    marks = []               # each step's (start, end) in the window, s
    err_last = None
    n_frames = n_failed = n_kf = 0
    rec = tracing.Recorder(B, device) if trace else None
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_done = t0
    with rec.count_syncs() if rec else contextlib.nullcontext(), \
            _gc_pauses() as gc_pauses:
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            rand = k_rand < n_rand and now - t0 >= sample_at[k_rand]
            imgs_at = [p % P for p in pos]
            before = entry.keep()
            ts = time.perf_counter()
            r = entry.step([frames[i] for i in imgs_at])
            t_done = time.perf_counter()
            lat.extend([(t_done - ts) * 1e3] * B)
            marks.append((ts - t0, t_done - t0))
            n_frames += B
            n_failed += int(r.failed.sum())
            n_kf += int(r.keyframe.sum())
            spans.extend(r.spans)
            err = r.t_wc - lap.t_wc[imgs_at]
            gt_err.append(np.linalg.norm(err, axis=1).max())
            if err_last is not None:
                gt_jump.append(np.linalg.norm(err - err_last, axis=1).max())
            err_last = err
            pos = [p + 1 for p in pos]
            if control:
                chain_frames.append(imgs_at[0])
            streams = set()
            if rand:
                streams |= {b for b in range(B) if (b - k_rand) % n_rand == 0}
                k_rand += 1
            if r.keyframe.any() and n_kf_samples < kf_cap \
                    and rng.random() < kf_share:
                streams |= {b for b in range(B) if r.keyframe[b]}
                n_kf_samples += 1
            if streams:
                samples.append(Sample(imgs_at, sorted(streams),
                                      entry.hold(before, streams),
                                      entry.hold(entry.keep(), streams), r))
            else:
                entry.release(before)
    window_s = t_done - t0
    _sync(device)
    jit1 = graphed.jit_stats()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    captures = sum(v["captures"] - jit0[k]["captures"]
                   for k, v in jit1.items())
    # the set-up's captures: the stage graphs' and the step graphs' seconds
    capture_s = sum(v["capture_s"] for v in jit1.values()) \
        + sum(g[1] for g in graphed.graphs())
    log(f"{workload}: window {window_s:.3f} s, {n_frames} frames, "
        f"{n_kf} keyframes, {n_failed} failed, {captures} stage captures "
        f"in the window")

    # -- what the traced run read -------------------------------------------------
    metrics = {}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        def step():
            nonlocal pos
            r = entry.step([frames[p % P] for p in pos])
            pos = [p + 1 for p in pos]
            return r
        rec.profile(step)
        record = rec.record(kind=entry.kind, frames=n_frames,
                            window_s=window_s, spans=spans,
                            jit=_jit_delta(jit0, jit1))
        for m in cell.per_layer:
            v = load_metric(m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(rec.device_times())
        breakdown = rec.breakdown()
        p = record["profile"]
        log(f"host syncs {record['syncs']}; profiled "
            + (f"{p['frames']} frames in {len(p['chunks'])} chunk(s), "
               f"{p['wall_s']:.3f} s, ending on a keyframe: {p['closed']}"
               if p else "nothing"))
    else:
        e2e = {"frames_per_s": stats.rate(n_frames, window_s),
               "frame_ms_p95": stats.p95(lat), "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    # -- the check, after the program's state is freed ----------------------------
    del r, before
    entry.close()
    graphed.clear()
    readings = check(entry, kept_start, samples, cfg_file, cam, frames, lap,
                     starts, device, control)
    values = compare.worst(readings)
    chain_gt = None
    if control:
        # the reference in the program's place along the window's chain
        from svo_bench.reference.runner import Reference
        ref = Reference(cfg_file, device)
        (ref.seed_handler if entry.kind == "handler" else ref.seed_step)(
            frames[starts[0]], lap.R_wc[starts[0]], lap.t_wc[starts[0]],
            scene.depth_map(cam, lap, starts[0], device))
        at = chain_frames[:CHAIN_FRAMES]
        t_ref = ref.chain(entry.kind, entry.leaves(chain_start[0]),
                          entry.fields(chain_start[0]),
                          [frames[i] for i in at], control=True)
        err = t_ref - lap.t_wc[at]
        chain_gt = {"frames": len(at),
                    "gt_gap_m": float(np.linalg.norm(err, axis=1).max()),
                    "gt_jump_m": float(np.linalg.norm(np.diff(err, axis=0),
                                                      axis=1).max())}
        values["gt_jump_m"] = chain_gt["gt_jump_m"]
    else:
        values["gt_jump_m"] = float(max(gt_jump)) if gt_jump \
            else math.inf
    verdict = compare.judge(values, cell.limits or {})
    bad = forbidden_modules()
    out = {"correct": verdict["correct"] and n_failed == 0 and not bad,
           "attempted": n_frames, "failed": n_failed, "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = verdict["checks"]
    return out, {"gt_max_m": float(max(gt_err)) if gt_err else None,
                 "gt_jump_max_m": float(max(gt_jump)) if gt_jump else None,
                 "control_chain": chain_gt,
                 "capture_s": capture_s,
                 "captures_in_window": captures, "keyframes": n_kf,
                 "latency_ms_p5_25_50_75_95_99": np.percentile(
                     lat, [5, 25, 50, 75, 95, 99]).tolist(),
                 "window_steps": _step_times(marks, B),
                 "window_gc_ms": gc_pauses,
                 "warm_steps": n_warm, "warm_keyframes": int(kfs.min()),
                 "samples": len(samples),
                 "sample_keyframes": sum(bool(s.result.keyframe.any())
                                         for s in samples),
                 "readings": readings, "forbidden": bad}


@contextlib.contextmanager
def _gc_pauses():
    """The collector's pauses while the block runs: for each generation
    collected, [count, longest ms, total ms]."""
    pauses, t = {}, [0.0]

    def note(phase, info):
        if phase == "start":
            t[0] = time.perf_counter()
            return
        ms = (time.perf_counter() - t[0]) * 1e3
        n, top, tot = pauses.get(info["generation"], (0, 0.0, 0.0))
        pauses[info["generation"]] = (n + 1, max(top, ms), tot + ms)
    gc.callbacks.append(note)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(note)


def _step_times(marks: list, B: int) -> dict:
    """Where the window's time went: inside the entry's calls or between
    them, the longest call and the longest gap, and the frames finished
    in each second of the window (a stall shows as a second short of
    frames)."""
    if not marks:
        return {}
    dur = np.array([e - s for s, e in marks])
    gaps = np.array([s1 - e0 for (_, e0), (s1, _) in zip(marks, marks[1:])]
                    or [0.0])
    ends = np.array([e for _, e in marks])
    per_s = np.bincount(ends.astype(np.int64)) * B
    return {"in_calls_s": float(dur.sum()),
            "between_calls_s": float(gaps.sum() + marks[0][0]),
            "call_ms_median_max": [float(np.median(dur) * 1e3),
                                   float(dur.max() * 1e3)],
            "calls_over_1.5x_median": int((dur > 1.5 * np.median(dur)).sum()),
            "gap_ms_max": float(gaps.max() * 1e3),
            "frames_each_second": per_s.tolist()}


def _jit_delta(j0: dict, j1: dict) -> dict:
    """The stage graphs' counters over the window, summed over functions."""
    keys = ("captures", "replays", "in_copied_mb", "out_copied_mb")
    return {k: sum(v[k] - j0.get(f, {}).get(k, 0) for f, v in j1.items())
            for k in keys}


def check(entry, kept_start, samples, cfg_file, cam, frames, lap, starts,
          device, control: bool) -> list:
    """Each stream's start, and each sample's streams, against the plain
    reference; with ``control``, the reference on bfloat16 inputs in the
    program's place.  Returns one reading per comparison."""
    from svo_bench.reference.runner import Reference
    from svo_bench.reference.svo.core.pipeline import RESULT_IS_KEYFRAME
    ref = Reference(cfg_file, device)
    handler = entry.kind == "handler"
    readings = []
    for b, s in enumerate(starts):
        depth = scene.depth_map(cam, lap, s, device)
        args = (frames[s], lap.R_wc[s], lap.t_wc[s], depth)
        m_ref = ref.seed_handler(*args).map if handler \
            else ref.seed_step(*args).m
        if not control:
            readings.append({"at": f"start {b}", **compare.map_gaps(
                entry.map_of(kept_start[b]), m_ref)})
    for k, smp in enumerate(samples):
        for b in smp.streams:
            i = smp.frames[b]
            held = smp.before[b]

            def step(ctl):
                leaves = entry.leaves(held)
                if handler:
                    pose, m, res = ref.handler_step(
                        leaves, entry.fields(held), frames[i], control=ctl)
                    return pose, m, res == RESULT_IS_KEYFRAME
                return ref.vo_step(leaves, frames[i], control=ctl)
            pose, m, kf = step(False)
            if control:
                got_pose, got_m, got_kf = step(True)
                got = (got_pose.R_wc, got_pose.t_wc)
            else:
                got = (smp.result.R_wc[b], smp.result.t_wc[b])
                got_m = entry.map_of(smp.after[b])
                got_kf = bool(smp.result.keyframe[b])
            reading = {
                "at": f"sample {k} stream {b} frame {i}"
                      + (" keyframe" if got_kf else ""),
                "pose_gap_m": compare.pose_gap(*got, pose.R_wc, pose.t_wc),
                **compare.map_gaps(got_m, m, entry.map_of(held))}
            if got_kf != kf:
                # the decisions differ: the maps' keyframes differ by it
                del reading["kf_mismatch"]
                reading["kf_flip"] = 1
            readings.append(reading)
    return readings
