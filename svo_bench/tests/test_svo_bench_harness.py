"""The harness's data, arithmetic and import rules, on the CPU."""

from __future__ import annotations

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest

from svo_bench import compare, harness, scene, stats, trace

BENCH_DIR = Path(harness.__file__).resolve().parent
REPO = BENCH_DIR.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_found_by_name(cell):
    c = harness.load_cell(cell, BENCH)
    assert c.cfg_file["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert hasattr(harness.load_entry(c.traffic["entry"]), "Entry")
    assert c.limits is not None and set(c.limits) == set(compare.NUMBERS)
    assert {m["name"] for m in c.end_to_end} >= {"frames_per_s",
                                                 "frame_ms_p95", "setup_s"}
    assert c.per_layer


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metrics_found_by_name(m):
    mod = harness.load_metric(m["name"])
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
        m["name"], m["unit"], m["layer"], m["moves"])
    # a reader that finds nothing returns nothing, never 0
    empty = {"kind": "step", "frames": 0, "window_s": 1.0, "spans": [],
             "jit": None, "grids": None, "profile": None, "syncs": None}
    assert mod.read(empty) is None


def test_config_files_state_what_runs():
    from svo_bench.entries.common import program_setup
    files = {REPO / c["file"] for c in BENCH["configs"]}
    # and the files kept for cells that are out for now
    files |= set((BENCH_DIR / "configs").glob("*.json"))
    for path in sorted(files):
        f = json.loads(path.read_text())
        cfg, cam, _ = program_setup(f)        # raises on any difference
        assert (cam.fx, f["img_shape"]) == (315.5, [480, 752])


@pytest.mark.parametrize("name,step,radius", [("cruise", 0.001785, 0.65),
                                              ("agile", 0.02, 3.2)])
def test_path_motion_and_lap(name, step, radius):
    p = json.loads((BENCH_DIR / "paths" / f"{name}.json").read_text())
    lap = scene.circle_path(p)
    n = len(lap.t_wc)
    assert n == round(2 * math.pi * radius / step)
    xy = lap.t_wc[:, :2]
    d = np.linalg.norm(np.diff(np.vstack([xy, xy[:1]]), axis=0), axis=1)
    # every step of the closed lap, the last to the first included
    np.testing.assert_allclose(d, 2 * math.pi * radius / n, rtol=1e-5)
    assert abs(d[0] - step) / step < 1e-3
    np.testing.assert_allclose(np.linalg.norm(xy, axis=1), radius)


def test_renderer_equals_the_port_scene():
    """The benchmark's plain renderer draws the bench scene as the port's
    renderer does (to float rounding)."""
    import torch
    from rpg_svo_tpu_torch.utils import synthetic
    cam = scene.Camera(160, 120, 60.0, 60.0, 80.0, 60.0)
    tex = scene.texture(7)
    p = {"radius": 0.3, "height": 1.5, "step": 0.05,
         "wobble": {"height": 0.05, "yaw": 0.1, "pitch": 0.03, "roll": 0.03}}
    lap = scene.circle_path(p)
    img, depth = scene._render(cam, tex, lap.R_wc[3:4], lap.t_wc[3:4], "cpu")
    pcam = synthetic.PinholeCamera.make(160, 120, 60.0, 60.0, 80.0, 60.0)
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    T = SE3(torch.as_tensor(lap.R_wc[3], dtype=torch.float32),
            torch.as_tensor(lap.t_wc[3], dtype=torch.float32))
    want, wdepth = synthetic.render_frame(
        pcam, synthetic.Texture(*tex), T, (120, 160))
    assert float((img[0] - want).abs().max()) < 0.05
    assert float((depth[0] - wdepth).abs().max()) < 1e-5


def test_rate_and_tail_over_all_frames():
    # a window of 90 fast frames, then 10 slow ones
    lat = [10.0] * 90 + [50.0] * 10
    assert stats.rate(len(lat), 1.4) == len(lat) / 1.4
    # the 95th percentile of all frames lies in the slow ones; the median
    # of five chunks' percentiles would not
    assert stats.p95(lat) == 50.0
    chunks = [stats.p95(lat[i:i + 20]) for i in range(0, 100, 20)]
    assert np.median(chunks) == 10.0
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_busy_share_is_an_interval_union():
    ev = [("a", 0, 10, None), ("b", 5, 10, None), ("c", 30, 5, None)]
    # 0-15 and 30-35: 20 ns, where a sum of durations gives 25
    assert trace.busy_s(ev) == pytest.approx(20e-9)
    gaps = trace.idle_gaps(ev, [("aten::item", 14, 31)], short_ns=1)
    assert gaps == [["aten::item", pytest.approx(15e-9)]]


def _map(ptype, pos, orig_kf, n_kf=3):
    import torch
    from types import SimpleNamespace as NS
    P = len(ptype) + 1          # the pools' last row is scratch
    pt = NS(ptype=torch.tensor(ptype + [0]),
            pos=torch.tensor(pos + [[0.0, 0.0, 0.0]]),
            orig_kf=torch.tensor(orig_kf + [-1]),
            orig_px=torch.zeros(P, 2))
    kf = NS(active=torch.tensor([True] * n_kf + [False]),
            R=torch.eye(3).expand(n_kf + 1, 3, 3), t=torch.zeros(n_kf + 1, 3))
    return NS(kf=kf, pt=pt, seed=NS(active=torch.zeros(4, dtype=torch.bool)))


def test_map_gap_pairs_points_by_what_they_are():
    """A point dropped on one side, its slot handed to a point born in
    the same step, is a mismatch and no position gap; the same births
    in other slots pair by origin."""
    before = _map([1, 1, 0, 0], [[0, 0, 1.5], [1, 0, 1.5], [0] * 3, [0] * 3],
                  [0, 0, -1, -1])
    # side a: point 1 dropped, its slot holds the birth from keyframe 2,
    # which side b holds in slot 2
    a = _map([1, 1, 0, 0], [[0, 0, 1.5], [0.5, 0.5, 1.4], [0] * 3, [0] * 3],
             [0, 2, -1, -1])
    b = _map([1, 1, 1, 0], [[0, 0, 1.5], [1, 0, 1.5], [0.5, 0.5, 1.4],
                            [0] * 3], [0, 0, 2, -1])
    g = compare.map_gaps(a, b, before)
    assert g["map_gap_m"] == 0.0
    assert g["map_mismatch"] == 1.0 and g["kf_mismatch"] == 0.0
    b.kf.active[1] = False
    assert compare.map_gaps(a, b, before)["kf_mismatch"] == 1.0


def test_idle_gaps_take_the_shortest_host_event_across_each():
    """The sweep names each gap by the shortest host event spanning its
    middle, as a search over every event does."""
    import random
    rnd = random.Random(5)
    dev = []
    t = 0
    for _ in range(200):
        t += rnd.choice([1, 2, 50, 400])
        d = rnd.randint(1, 30)
        dev.append(("k", t, d, None))
        t += d
    host = []
    for j in range(300):
        s = rnd.randint(0, t)
        # durations all differ, so that the shortest is one event
        host.append((f"h{j}", s, s + rnd.choice([3, 40, 700, 5000])
                     + j / 1000))
    got = dict((n, v) for n, v in trace.idle_gaps(dev, host, short_ns=10))
    want = {}
    busy = stats.merge((s, s + d) for _, s, d, _ in dev)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = (s1 - e0) / 1e9
        if s1 - e0 < 10:
            name = "gaps under 0.01 us"
        else:
            mid = (e0 + s1) / 2
            inside = [h for h in host if h[1] <= mid <= h[2]]
            name = min(inside, key=lambda h: h[2] - h[1])[0] if inside \
                else "host outside any recorded op"
        want[name] = want.get(name, 0.0) + gap
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k])


def test_k1_work_count_equals_chip_smoke():
    """chip_smoke.py counts K1's bytes at 17x17x256 as each tile element
    read and written once plus 20 bytes of request and origin a tile; the
    grid of that launch (289 blocks of 256 threads) gives the tile part
    exactly."""
    k1 = harness.load_metric("kernel.K1_roofline")
    n, side = 256, 17
    smoke = 2 * n * side * side * 4 + 5 * n * 4
    grid = [-(-n * side * side // 256), 1, 1]
    assert k1.k1_bytes(grid) + 5 * n * 4 == smoke


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_anywhere_in_the_benchmark():
    bad = [(str(p), m) for p in BENCH_DIR.rglob("*.py")
           for m in _imports(p)
           if m.split(".")[0] in harness.FORBIDDEN]
    assert not bad


def test_reference_imports_nothing_of_the_program():
    mods = [(str(p), m) for p in (BENCH_DIR / "reference").rglob("*.py")
            for m in _imports(p)]
    assert not [(p, m) for p, m in mods
                if m.split(".")[0] in ("rpg_svo_tpu_torch",)
                + harness.FORBIDDEN]
    # of the benchmark, only the reference itself
    assert not [(p, m) for p, m in mods if m.split(".")[0] == "svo_bench"
                and not m.startswith("svo_bench.reference")]


def test_forbidden_names_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "rpg_svo_tpu_torch_x",
                        types.ModuleType("rpg_svo_tpu_torch_x"))
    assert "rpg_svo_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rpg_svo_tpu.core",
                        types.ModuleType("rpg_svo_tpu.core"))
    assert harness.forbidden_modules() == ["rpg_svo_tpu.core"]
