#!/usr/bin/env python3
"""Smoke run of the PyTorch and CUDA port (rpg_svo_tpu_torch) on one card.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, and fails (nonzero exit, no result line) without
one, or without the port beside it.  Phases, each fatal on failure:

1. header: the card's name and power limit; build both kernels with nvcc;
2. K1 (tile gather, clamp in the kernel) against its plain twin at the
   four main-path shapes on a rendered 752x480 frame's pyramid: tiles
   bit-exact, clamped origins equal to an independent numpy clamp; the
   whole ``gather_tiles`` call timed beside the index call and the
   kernel's profiler device time;
3. K2 (the whole sparse alignment in one launch) against its plain twin
   ``sparse_img_align_plain`` (its tiles cut by ``gather_tiles_plain``)
   at N = 128 on levels 4-2 of the rendered frame 0/5 pair, for 6 seeded
   initial perturbations: the same tracked count and iterations at every
   level, poses within 1e-5; device time, time per iteration;
4. tracking: the bench scene (441-frame circle, radius 0.25 m, half a
   revolution), seeded from frame 0, then ``vo_step`` on frames 1-40 in
   the bench's fast settings with the keyframe and depth-filter stages
   stubbed; no frame may fail, each kernel launches once per frame, the
   step has no host sync and at most MAX_DEVICE_OPS device ops;
5. the same step on the CPU (plain twins) for the first 10 frames, from
   the same seeded state, against the card's trajectory;
6. one JSON line of kernel measurements, the card's line, and the result.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

FRAMES = 40
CPU_FRAMES = 10
# card vs CPU trajectory agreement (m): the kernels sum in other orders
# than the twins (measured about 2e-6 m over 10 frames)
CPU_TOL_M = 1e-4
# K2 vs its twin (m, and rotation entries): float summation order only
# (measured about 2e-7); tracked counts and iterations must be equal
K2_TOL = 1e-5
K2_TRIALS = 6                  # seeded initial perturbations of frame 0/5
# K2's operations per valid feature (bound_ms): the prologue of a level,
# 16 px x (5 four-tap blends x 7 + 2 differences x 2 + 6 Jacobian
# entries x 3) + jacobian_xyz2uv ~20 + 21 H terms x 16 px x 2 ~ 1600; a
# pass, projection ~40 + 16 px x (bilinear 9 + residual 1 + Jr and r^2
# 7 x 2) + 21 H-term sums ~ 450; per iteration the 6x6 solve and the
# SE3 step ~ 300
K2_PROLOGUE_FLOPS = 1600
K2_PASS_FLOPS = 450
K2_SOLVE_FLOPS = 300
# device ops per tracking step: the eager step with sparse alignment in
# one launch and K1's clamp in the kernel issues about 4950
MAX_DEVICE_OPS = 5030
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: no output"


def _cuda_ms(torch, fn, reps: int = 50, warm: int = 5,
             trials: int = 5) -> float:
    """Median over trials of the mean time of `reps` back-to-back calls
    (CUDA events).  For launch-sized work this is the host's enqueue rate,
    not the kernel's device time (see the profiler figures)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _device_us(torch, fn, sym: str, reps: int = 20) -> float:
    """Median device time (us) of the kernels named `sym` over `reps`
    calls of `fn`, from torch.profiler; each call must launch one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and sym in e.name]
    assert len(us) == reps, (sym, len(us))
    return statistics.median(us)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "rpg_svo_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout holding rpg_svo_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from rpg_svo_tpu_torch.config import bench_cfg
    from rpg_svo_tpu_torch.core import fused
    from rpg_svo_tpu_torch.core.convert import state_from_numpy, state_to_numpy
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    from rpg_svo_tpu_torch.ops import align_kernel, cuda_build, tiles
    from rpg_svo_tpu_torch.ops.detector import grid_dims
    from rpg_svo_tpu_torch.ops.pyramid import build_padded_pyramid
    from rpg_svo_tpu_torch.ops.sparse_align import sparse_img_align_plain
    from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset

    dev = torch.device("cuda")
    smi = _smi_line()
    print(f"# card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # --- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build()
    print(f"# built kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}")

    shape = (480, 752)
    cfg = bench_cfg("fast").replace(ablate=("kf", "df"))
    ds = SyntheticDataset(n_frames=441, trajectory="circle", radius=0.25,
                          revolutions=0.5, shape=shape, device=dev)
    cam = ds.cam
    ncx, ncy = grid_dims(shape[1], shape[0], cfg.grid_size)
    C = ncx * ncy
    img0, depth0, T0 = ds.frame(0)
    pad0 = build_padded_pyramid(img0, cfg.n_levels_total)

    # --- 2. K1 against its twin ---------------------------------------------
    rng = np.random.default_rng(0)
    k1_cases = [("align", 17, 128, (4, 3, 2)), ("ref_patch", 8, 128,
                                                   (4, 3, 2)),
                ("reproject", 17, 256, (0, 1, 2)),
                ("seed_tiles", 24, C, (0, 1, 2))]
    k1_shapes = []
    tab = np.asarray([[w for _, w in pad0.shapes],
                      [h for h, _ in pad0.shapes]])
    stack = pad0.stack
    for label, side, n, lvls in k1_cases:
        lv = rng.choice(lvls, n).astype(np.int32)
        W, H = tab[0][lv], tab[1][lv]
        # origins over and past every edge of each level
        x0 = rng.integers(-20, W + 20).astype(np.int32)
        y0 = rng.integers(-20, H + 20).astype(np.int32)
        args = (pad0, torch.from_numpy(lv).to(dev),
                torch.from_numpy(x0).to(dev), torch.from_numpy(y0).to(dev),
                side, side)
        out, x0c, y0c = tiles.gather_tiles(*args)
        want_x = np.clip(x0, 0, np.maximum(W - side, 0))
        want_y = np.clip(y0, 0, np.maximum(H - side, 0))
        assert np.array_equal(x0c.cpu().numpy(), want_x), label
        assert np.array_equal(y0c.cpu().numpy(), want_y), label
        plain, px0c, py0c = tiles.gather_tiles_plain(*args)
        assert torch.equal(out, plain), f"K1 differs from its twin: {label}"
        assert torch.equal(x0c, px0c) and torch.equal(y0c, py0c), label
        y0g = (py0c + torch.from_numpy(pad0.row_off[lv]).to(dev)).long()
        r = torch.arange(side, device=dev)
        idx = ((y0g[:, None, None] + r[None, :, None]) * stack.shape[1]
               + px0c.long()[:, None, None] + r[None, None, :])
        ms = _cuda_ms(torch, lambda: tiles.gather_tiles(*args))
        plain_ms = _cuda_ms(torch, lambda: tiles.gather_tiles_plain(*args))
        lib_ms = _cuda_ms(torch, lambda: stack.view(-1)[idx])
        dev_us = _device_us(torch, lambda: tiles.gather_tiles(*args),
                            "tile_gather_kernel")
        # tiles read and written once, requests read and origins written
        nbytes = 2 * n * side * side * 4 + 5 * n * 4
        k1_shapes.append({"shape": f"{side}x{side}x{n}", "use": label,
                          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "device_us": dev_us,
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        print(f"# K1 {label} {side}x{side}x{n}: bit-exact, origins exact; "
              f"gather_tiles {ms:.4f} ms (device {dev_us:.2f} us), twin "
              f"{plain_ms:.4f} ms, index call {lib_ms:.4f} ms", flush=True)

    # --- 3. K2 against its twin ---------------------------------------------
    state0 = fused.seed_first_frame_with_depth(img0, T0.inverse(), depth0,
                                               cam, cfg, img_shape=shape,
                                               device=dev)
    pad5 = build_padded_pyramid(ds.frame(5)[0], cfg.n_levels_total)
    m = state0.m
    pid = torch.clamp(state0.feat_point, 0).long()
    T_ref = SE3(state0.R, state0.t)
    depth = torch.linalg.vector_norm(T_ref.apply(m.pt.pos[pid]), dim=-1)
    levels = range(cfg.klt_max_level, cfg.klt_min_level - 1, -1)
    N = int(depth.shape[0])
    # the features valid at each level (unclamped 8x8 reference origin):
    # the bound counts what these need, 7x7 reference pixels (the blend's
    # support) and at least one 5x5 current window each
    px_h = state0.feat_px.cpu().numpy()
    ok_in = state0.feat_valid.cpu().numpy() & (depth.cpu().numpy() > 1e-6)
    n_ok = {}
    for l in levels:
        h, w = pad5.shapes[l]
        want = np.floor(px_h * np.float32(2.0 ** -l)).astype(np.int64) - 3
        n_ok[l] = int((ok_in & (want[:, 0] >= 0) & (want[:, 1] >= 0)
                       & (want[:, 0] <= max(w - 8, 0))
                       & (want[:, 1] <= max(h - 8, 0))).sum())
    k2_runs = []
    k2_err = 0.0
    for trial in range(K2_TRIALS):
        xi = torch.tensor(rng.normal(0, [3e-3] * 3 + [2e-3] * 3),
                          dtype=torch.float32, device=dev)
        args = (state0.pad, pad5, cam, SE3.exp(xi), state0.feat_px,
                state0.feat_f, depth, state0.feat_valid, cfg.klt_max_level,
                cfg.klt_min_level, cfg.img_align_n_iter, cfg.img_align_eps)
        Tk, nk, Hk, ck, ik = align_kernel.sparse_align_kernel(*args)
        twin = functools.partial(sparse_img_align_plain, *args,
                                 gather=tiles.gather_tiles_plain)
        rp = twin()
        Tp = rp.T_cur_ref
        dt = float(torch.linalg.vector_norm(Tk.t - Tp.t))
        dR = float(torch.abs(Tk.R - Tp.R).max())
        dn = abs(int(nk) - int(rp.n_tracked))
        iters = {l: int(ik[l]) for l in levels}
        twin_iters = {l: int(rp.iters[l]) for l in levels}
        assert dt < K2_TOL and dR < K2_TOL and dn == 0 \
            and iters == twin_iters, \
            f"K2 differs from its twin, trial {trial}: dt={dt} dR={dR} " \
            f"dn={dn} iterations {iters} against {twin_iters}"
        assert torch.isfinite(Hk).all() and bool(torch.isfinite(ck))
        k2_err = max(k2_err, float(torch.abs(Tk.t - Tp.t).max()), dR)
        ms = _cuda_ms(torch, lambda: align_kernel.sparse_align_kernel(*args))
        plain_ms = _cuda_ms(torch, twin, reps=2, warm=1, trials=3) \
            if trial == 0 else None
        dev_us = _device_us(torch,
                            lambda: align_kernel.sparse_align_kernel(*args),
                            "sparse_align_kernel")
        # bytes these inputs need: the valid features' regions at each
        # level, every feature's pixel, bearing, depth and validity, the
        # pose; the output row
        nbytes = sum(n_ok.values()) * (49 + 25) * 4 + N * (6 * 4 + 1) \
            + 12 * 4 + align_kernel.OUT_LEN * 4
        # operations: each level's prologue, one pass per iteration plus
        # the level's final evaluation, one solve per iteration
        flops = sum(n_ok[l] * (K2_PROLOGUE_FLOPS
                               + K2_PASS_FLOPS * (iters[l] + 1))
                    + K2_SOLVE_FLOPS * iters[l] for l in levels)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        k2_runs.append({"trial": trial, "ms": ms, "plain_ms": plain_ms,
                        "device_us": dev_us, "iterations": iters,
                        "us_per_iteration": dev_us / sum(iters.values()),
                        "bound_ms": bound,
                        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / F32_FLOPS_PER_S else "operations",
                        "features_valid_per_level": n_ok,
                        "dt": dt, "dR": dR, "dn": dn})
        print(f"# K2 trial {trial}: dt {dt:.2e} dR {dR:.2e} dn {dn}; "
              f"device {dev_us:.2f} us, iterations {iters} "
              f"({dev_us / sum(iters.values()):.2f} us each), bound "
              f"{bound * 1e3:.4f} us, call {ms:.4f} ms"
              + (f", twin {plain_ms:.3f} ms" if plain_ms else ""),
              flush=True)

    # --- 4. tracking on the card ------------------------------------------
    imgs = [ds.frame(i)[0] for i in range(1, FRAMES + 1)]
    gt = np.stack([ds.poses[i].t.cpu().numpy()
                   for i in range(1, FRAMES + 1)])
    torch.cuda.synchronize()
    tiles.tile_gather_kernel.launches = 0
    align_kernel.sparse_align_kernel.launches = 0
    state = state0
    outs = []
    t0 = time.perf_counter()
    for img in imgs:
        state, out = fused.vo_step(state, img, cam, cfg, ncx, ncy, shape)
        outs.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"tile_gather": tiles.tile_gather_kernel.launches,
                "sparse_align": align_kernel.sparse_align_kernel.launches}
    failed = [i + 1 for i, o in enumerate(outs) if bool(o.failed)]
    pos = np.stack([o.t_wc.cpu().numpy() for o in outs])
    terr = np.linalg.norm(pos - gt, axis=-1)
    assert pos.shape == (FRAMES, 3) and np.isfinite(pos).all()
    assert not failed, f"frames failed: {failed}"
    # one alignment launch and one K1 launch (the reprojector's feature
    # alignment) per frame
    assert launches == {"tile_gather": FRAMES, "sparse_align": FRAMES}, \
        launches
    print(f"# tracking {FRAMES} frames: median terr "
          f"{np.median(terr) * 1e3:.3f} mm, max {terr.max() * 1e3:.3f} mm, "
          f"{wall / FRAMES * 1e3:.2f} ms/frame, launches {launches}",
          flush=True)
    assert np.median(terr) < 0.01, "tracking lost the ground truth"

    # host syncs left in one step (CUDA sync debug mode), by source line
    syncs = []

    def note_sync(message, *_args, **_kw):
        if "called a synchronizing" in str(message):
            here = [f for f in traceback.extract_stack()
                    if "rpg_svo_tpu_torch" in f.filename]
            syncs.append(f"{Path(here[-1].filename).name}:{here[-1].lineno} "
                         f"{here[-1].line}" if here else "outside the port")

    extra = [ds.frame(FRAMES + 1 + i)[0] for i in range(4)]
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note_sync
        torch.cuda.set_sync_debug_mode("warn")
        fused.vo_step(state, extra[0], cam, cfg, ncx, ncy, shape)
        torch.cuda.set_sync_debug_mode("default")
    print(f"# host syncs in one step: {len(syncs)}"
          + "".join(f"\n#   {s}" for s in syncs), flush=True)
    assert not syncs, "the step waits on the card"

    # device time of three steps by kernel (torch.profiler)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = state
        for img in extra[1:]:
            st, _ = fused.vo_step(st, img, cam, cfg, ncx, ncy, shape)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / 3
    print(f"# profile: {len(dev_events) / 3:.0f} device ops per step, "
          f"{busy_ms:.2f} ms device time per step", flush=True)
    assert len(dev_events) / 3 <= MAX_DEVICE_OPS, len(dev_events) / 3
    # each kernel's own device time on the main path, by kernel name
    device_ms = {}
    for key, sym in (("tile_gather", "tile_gather_kernel"),
                     ("sparse_align", "sparse_align_kernel")):
        us = [e.time_range.elapsed_us() for e in dev_events if sym in e.name]
        device_ms[key] = statistics.median(us) / 1e3 if us else None
        print(f"# profile: {key} {len(us) / 3:.0f} launches per step, "
              f"median device time {device_ms[key]} ms", flush=True)
    out_dir = root / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=40))

    # --- 5. the CPU path from the same seeded state ------------------------
    cpu_state = state_from_numpy(state_to_numpy(state0), device="cpu")
    cpu_pos = []
    t0 = time.perf_counter()
    for img in imgs[:CPU_FRAMES]:
        cpu_state, out = fused.vo_step(cpu_state, img.cpu(), cam, cfg, ncx,
                                       ncy, shape)
        cpu_pos.append(out.t_wc.numpy())
        assert not bool(out.failed)
    cpu_wall = time.perf_counter() - t0
    dpos = np.abs(np.stack(cpu_pos) - pos[:CPU_FRAMES]).max()
    print(f"# card vs CPU over {CPU_FRAMES} frames: max |dt_wc| "
          f"{dpos:.3e} m (tol {CPU_TOL_M}); CPU "
          f"{cpu_wall / CPU_FRAMES * 1e3:.1f} ms/frame", flush=True)
    assert dpos < CPU_TOL_M, dpos

    # --- 6. the lines --------------------------------------------------------
    per_frame = {k: v / FRAMES for k, v in launches.items()}
    main_k1 = next(s for s in k1_shapes if s["use"] == "reproject")
    kernels = [
        {"name": "tile_gather", "route": "cuda",
         "source": "rpg_svo_tpu_torch/csrc/tile_gather.cu",
         "replaces": "rpg_svo_tpu/ops/pallas_tiles.py:126",
         "launches": launches["tile_gather"], "max_abs_err": 0.0,
         "ms": main_k1["ms"], "plain_ms": main_k1["plain_ms"],
         "bound_ms": main_k1["bound_ms"], "bound_by": "bytes",
         "library_ms": main_k1["library_ms"],
         "launches_per_frame": per_frame["tile_gather"],
         "device_ms": device_ms["tile_gather"],
         "by_shape": k1_shapes},
        {"name": "sparse_align", "route": "cuda",
         "source": "rpg_svo_tpu_torch/csrc/sparse_align.cu",
         "replaces": "rpg_svo_tpu/ops/pallas_align.py:58",
         "launches": launches["sparse_align"], "max_abs_err": k2_err,
         "ms": statistics.median(r["ms"] for r in k2_runs),
         "plain_ms": k2_runs[0]["plain_ms"],
         "bound_ms": statistics.median(r["bound_ms"] for r in k2_runs),
         "bound_by": k2_runs[0]["bound_by"], "library_ms": None,
         "launches_per_frame": per_frame["sparse_align"],
         "device_ms": device_ms["sparse_align"],
         "by_trial": k2_runs},
    ]
    summary = {"frames": FRAMES, "median_terr_mm": float(np.median(terr)) * 1e3,
               "max_terr_mm": float(terr.max()) * 1e3,
               "ms_per_frame": wall / FRAMES * 1e3,
               "cpu_ms_per_frame": cpu_wall / CPU_FRAMES * 1e3,
               "card_vs_cpu_max_dt_m": float(dpos),
               "host_syncs_per_step": len(syncs),
               "device_ops_per_step": len(dev_events) / 3,
               "device_ms_per_step": busy_ms}
    print("# summary " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
