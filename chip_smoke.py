#!/usr/bin/env python3
"""Smoke run of the PyTorch and CUDA port (rpg_svo_tpu_torch) on one card.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, and fails (nonzero exit, no result line) without
one, or without the port beside it.  Phases, each fatal on failure:

1. header: the card's name and power limit; build both kernels with nvcc;
2. K1 (tile gather, clamp in the kernel) against its plain twin at every
   call-site shape of the fast and accurate steps (reprojection and
   epipolar align windows, keyframe feature tiles, seed detection tiles,
   first-frame tiles, and the twin's alignment tiles) on a rendered
   752x480 frame's pyramid: tiles bit-exact, clamped origins equal to an
   independent numpy clamp; the whole ``gather_tiles`` call timed beside
   the index call and the kernel's profiler device time;
3. K2 (the whole sparse alignment in one launch) against its plain twin
   ``sparse_img_align_plain`` (its tiles cut by ``gather_tiles_plain``) on
   levels 4-2 of the rendered frame 0/5 pair, at N = 128 (fast) and
   N = 256 (accurate) features, for seeded initial perturbations: the
   same tracked count and iterations at every level, poses within 1e-5;
4. slice A (keyframes and depth filter stubbed) over 20 frames of the bench
   scene: no failure, one launch of each kernel per frame;
5. the fast and then the accurate preset (``bench_cfg``, ``ablate=()``)
   over all 440 frames of the bench scene (441-frame circle, radius
   0.25 m, half a revolution), seeded from frame 0 as ``bench.py::
   run_preset`` does: median and max translation error over frames
   41-440 within the limits, no failed frame, exactly 4 K1 and 1 K2
   launches per frame, 0 host syncs in one keyframe step and one other
   step, device ops and device time of each;
6. the fast step on the CPU (plain twins) over the 20 frames holding the
   first keyframe, from the card's state before them: equal keyframe
   decisions, max |dt_wc| <= 1e-3 m;
7. one JSON line of kernel measurements, the card's line, and the result.
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

N_FRAMES = 441                 # the bench scene: frame 0 seeds, 1-440 track
TIMED_FROM = 41                # bench.py's timed frames are 41-440
SLICE_A_FRAMES = 20
CPU_FRAMES = 20
SNAP_EVERY = 20                # states kept for the replays
# translation error limits (mm, median and max over frames 41-440): the
# JAX package's pins (BENCH_r05.json, 2.39/4.34 and 1.89/4.29 mm) plus 10%
# and 20%
LIMITS_MM = {"fast": (2.63, 5.2), "accurate": (2.08, 5.15)}
# card vs CPU trajectory agreement (m) over CPU_FRAMES frames
CPU_TOL_M = 1e-3
# K2 vs its twin (m, and rotation entries): float summation order only;
# tracked counts and iterations must be equal
K2_TOL = 1e-5
K2_TRIALS = {128: 6, 256: 3}   # seeded perturbations at each feature count
# K1 launches per frame on the full step: the reprojector's align windows,
# the epipolar align2D windows, the keyframe feature tiles and the seed
# detection tiles (each runs every frame, its result kept on keyframes)
K1_PER_FRAME = 4
# K2's operations per valid feature (bound_ms): the prologue of a level,
# 16 px x (5 four-tap blends x 7 + 2 differences x 2 + 6 Jacobian
# entries x 3) + jacobian_xyz2uv ~20 + 21 H terms x 16 px x 2 ~ 1600; a
# pass, projection ~40 + 16 px x (bilinear 9 + residual 1 + Jr and r^2
# 7 x 2) + 21 H-term sums ~ 450; per iteration the 6x6 solve and the
# SE3 step ~ 300
K2_PROLOGUE_FLOPS = 1600
K2_PASS_FLOPS = 450
K2_SOLVE_FLOPS = 300
# device ops per slice-A step: the eager step with sparse alignment in
# one launch and K1's clamp in the kernel issues about 4960
MAX_SLICE_A_DEVICE_OPS = 5030
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
    calls of `fn`, from torch.profiler; each call launches one, and the
    profiler may drop an event or two of a run (seen on the H100)."""
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
    assert reps // 2 <= len(us) <= reps, (sym, len(us))
    return statistics.median(us)


def _device_profile(torch, fn):
    """(device ops, device ms, {kernel: device ms}) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    by = {k: sum(e.time_range.elapsed_us() for e in ev if s in e.name) / 1e3
          for k, s in (("tile_gather", "tile_gather_kernel"),
                       ("sparse_align", "sparse_align_kernel"))}
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3, by, prof


def _host_syncs(torch, fn):
    """Source lines of the port that wait on the card during fn (CUDA
    sync debug mode)."""
    syncs = []

    def note_sync(message, *_args, **_kw):
        if "called a synchronizing" in str(message):
            here = [f for f in traceback.extract_stack()
                    if "rpg_svo_tpu_torch" in f.filename]
            syncs.append(f"{Path(here[-1].filename).name}:{here[-1].lineno} "
                         f"{here[-1].line}" if here else "outside the port")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note_sync
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, syncs


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
    from rpg_svo_tpu_torch.core.reprojector import attempt_budget
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
    t_start = time.perf_counter()

    # --- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build()
    print(f"# built kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}")

    shape = (480, 752)
    cfgs = {p: bench_cfg(p) for p in ("fast", "accurate")}
    ds = SyntheticDataset(n_frames=N_FRAMES, trajectory="circle",
                          radius=0.25, revolutions=0.5, shape=shape,
                          device=dev)
    cam = ds.cam
    ncx, ncy = grid_dims(shape[1], shape[0], cfgs["fast"].grid_size)
    C = ncx * ncy
    img0, depth0, T0 = ds.frame(0)
    pad0 = build_padded_pyramid(img0, cfgs["fast"].n_levels_total)

    # --- 2. K1 against its twin at the call-site shapes ---------------------
    rng = np.random.default_rng(0)
    k1_cases = [("sparse_align_twin", 17, 128, (4, 3, 2)),
                ("ref_patch", 8, 128, (4, 3, 2)),
                ("first_frame", 24, C, (0, 1, 2))]
    for p, cfg in cfgs.items():
        F = fused.frame_feature_cap(C, cfg.max_fts)
        k1_cases += [
            (f"reproject_{p}", 17,
             attempt_budget(C, F, cfg.reproj_attempt_factor), (0, 1, 2)),
            (f"epipolar_{p}", 17, cfg.df_update_k, (0, 1, 2)),
            (f"kf_tiles_{p}", 24, F, (0, 1, 2)),
            (f"seed_tiles_{p}", 24, min(C, cfg.max_seeds_per_kf), (0, 1, 2))]
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

    # --- 3. K2 against its twin at N = 128 and N = 256 ----------------------
    pad5 = build_padded_pyramid(ds.frame(5)[0], cfgs["fast"].n_levels_total)
    seeded = {p: fused.seed_first_frame_with_depth(
        img0, T0.inverse(), depth0, cam, cfg, img_shape=shape, device=dev)
        for p, cfg in cfgs.items()}
    k2_runs = []
    k2_err = 0.0
    for p, state0 in seeded.items():
        cfg = cfgs[p]
        m = state0.m
        pid = torch.clamp(state0.feat_point, 0).long()
        depth = torch.linalg.vector_norm(
            SE3(state0.R, state0.t).apply(m.pt.pos[pid]), dim=-1)
        levels = range(cfg.klt_max_level, cfg.klt_min_level - 1, -1)
        N = int(depth.shape[0])
        # the features valid at each level (unclamped 8x8 reference
        # origin): the bound counts what these need, 7x7 reference pixels
        # (the blend's support) and at least one 5x5 current window each
        px_h = state0.feat_px.cpu().numpy()
        ok_in = state0.feat_valid.cpu().numpy() & (depth.cpu().numpy() > 1e-6)
        n_ok = {}
        for l in levels:
            h, w = pad5.shapes[l]
            want = np.floor(px_h * np.float32(2.0 ** -l)).astype(np.int64) - 3
            n_ok[l] = int((ok_in & (want[:, 0] >= 0) & (want[:, 1] >= 0)
                           & (want[:, 0] <= max(w - 8, 0))
                           & (want[:, 1] <= max(h - 8, 0))).sum())
        for trial in range(K2_TRIALS[N]):
            xi = torch.tensor(rng.normal(0, [3e-3] * 3 + [2e-3] * 3),
                              dtype=torch.float32, device=dev)
            args = (state0.pad, pad5, cam, SE3.exp(xi), state0.feat_px,
                    state0.feat_f, depth, state0.feat_valid,
                    cfg.klt_max_level, cfg.klt_min_level,
                    cfg.img_align_n_iter, cfg.img_align_eps)
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
                f"K2 differs from its twin, N={N} trial {trial}: dt={dt} " \
                f"dR={dR} dn={dn} iterations {iters} against {twin_iters}"
            assert torch.isfinite(Hk).all() and bool(torch.isfinite(ck))
            k2_err = max(k2_err, float(torch.abs(Tk.t - Tp.t).max()), dR)
            ms = _cuda_ms(torch,
                          lambda: align_kernel.sparse_align_kernel(*args))
            plain_ms = _cuda_ms(torch, twin, reps=2, warm=1, trials=3) \
                if trial == 0 else None
            dev_us = _device_us(
                torch, lambda: align_kernel.sparse_align_kernel(*args),
                "sparse_align_kernel")
            # bytes these inputs need: the valid features' regions at each
            # level, every feature's pixel, bearing, depth and validity,
            # the pose; the output row
            nbytes = sum(n_ok.values()) * (49 + 25) * 4 + N * (6 * 4 + 1) \
                + 12 * 4 + align_kernel.OUT_LEN * 4
            # operations: each level's prologue, one pass per iteration
            # plus the level's final evaluation, one solve per iteration
            flops = sum(n_ok[l] * (K2_PROLOGUE_FLOPS
                                   + K2_PASS_FLOPS * (iters[l] + 1))
                        + K2_SOLVE_FLOPS * iters[l] for l in levels)
            bound = max(nbytes / HBM_BYTES_PER_S,
                        flops / F32_FLOPS_PER_S) * 1e3
            k2_runs.append({"n_features": N, "trial": trial, "ms": ms,
                            "plain_ms": plain_ms, "device_us": dev_us,
                            "iterations": iters,
                            "us_per_iteration": dev_us / sum(iters.values()),
                            "bound_ms": bound,
                            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                            >= flops / F32_FLOPS_PER_S else "operations",
                            "features_valid_per_level": n_ok,
                            "dt": dt, "dR": dR, "dn": dn})
            print(f"# K2 N={N} trial {trial}: dt {dt:.2e} dR {dR:.2e} dn "
                  f"{dn}; device {dev_us:.2f} us, iterations {iters} "
                  f"({dev_us / sum(iters.values()):.2f} us each), bound "
                  f"{bound * 1e3:.4f} us, call {ms:.4f} ms"
                  + (f", twin {plain_ms:.3f} ms" if plain_ms else ""),
                  flush=True)

    imgs = [ds.frame(i)[0] for i in range(1, N_FRAMES)]
    gt = np.stack([ds.poses[i].t.cpu().numpy() for i in range(1, N_FRAMES)])

    def reset_counts():
        torch.cuda.synchronize()
        tiles.tile_gather_kernel.launches = 0
        align_kernel.sparse_align_kernel.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {"tile_gather": tiles.tile_gather_kernel.launches,
                "sparse_align": align_kernel.sparse_align_kernel.launches}

    # --- 4. slice A: keyframes and depth filter stubbed ----------------------
    cfg_a = cfgs["fast"].replace(ablate=("kf", "df"))
    state = seeded["fast"]
    reset_counts()
    outs = []
    for img in imgs[:SLICE_A_FRAMES]:
        state, out = fused.vo_step(state, img, cam, cfg_a, ncx, ncy, shape)
        outs.append(out)
    launches_a = read_counts()
    pos = np.stack([o.t_wc.cpu().numpy() for o in outs])
    terr_a = np.linalg.norm(pos - gt[:SLICE_A_FRAMES], axis=-1)
    assert not any(bool(o.failed) for o in outs), "slice A: a frame failed"
    assert launches_a == {"tile_gather": SLICE_A_FRAMES,
                          "sparse_align": SLICE_A_FRAMES}, launches_a
    assert np.median(terr_a) < 0.01, "slice A lost the ground truth"
    ops_a, ms_a, _, _ = _device_profile(
        torch, lambda: fused.vo_step(state, imgs[SLICE_A_FRAMES], cam, cfg_a,
                                     ncx, ncy, shape))
    print(f"# slice A, {SLICE_A_FRAMES} frames: median terr "
          f"{np.median(terr_a) * 1e3:.3f} mm, launches {launches_a}, "
          f"{ops_a} device ops and {ms_a:.2f} ms device time per step",
          flush=True)
    assert ops_a <= MAX_SLICE_A_DEVICE_OPS, ops_a

    # --- 5. the fast and accurate presets over the whole scene --------------
    def run_path(preset):
        cfg = cfgs[preset]
        state = seeded[preset]
        snaps = {0: state}
        outs = []
        reset_counts()
        t0 = time.perf_counter()
        for i, img in enumerate(imgs, start=1):
            state, out = fused.vo_step(state, img, cam, cfg, ncx, ncy, shape)
            outs.append(out)
            if i % SNAP_EVERY == 0:
                snaps[i] = state
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        n = len(imgs)
        failed = [i + 1 for i, o in enumerate(outs) if bool(o.failed)]
        kf_frames = [i + 1 for i, o in enumerate(outs)
                     if bool(o.is_keyframe)]
        pos = np.stack([o.t_wc.cpu().numpy() for o in outs])
        assert pos.shape == (n, 3) and np.isfinite(pos).all()
        terr = np.linalg.norm(pos - gt, axis=-1)[TIMED_FROM - 1:]
        med, mx = float(np.median(terr)) * 1e3, float(terr.max()) * 1e3
        print(f"# {preset}: {n} frames, {wall / n * 1e3:.2f} ms/frame; "
              f"terr over frames {TIMED_FROM}-{n}: median {med:.3f} mm, max "
              f"{mx:.3f} mm; keyframes at {kf_frames}; launches {launches}",
              flush=True)
        assert not failed, f"{preset}: frames failed: {failed}"
        lim = LIMITS_MM[preset]
        assert med <= lim[0] and mx <= lim[1], (preset, med, mx, lim)
        assert launches == {"tile_gather": K1_PER_FRAME * n,
                            "sparse_align": n}, launches
        assert kf_frames, f"{preset}: no keyframe"
        # replay to the first keyframe from the snapshot before it: host
        # syncs, device ops and device time of that step and the next
        k = kf_frames[0]
        s = max(i for i in snaps if i < k)
        st = snaps[s]
        for j in range(s + 1, k):
            st, _ = fused.vo_step(st, imgs[j - 1], cam, cfg, ncx, ncy, shape)
        steps = {}
        for label, j in (("keyframe", k), ("other", k + 1)):
            step = functools.partial(fused.vo_step, st, imgs[j - 1], cam, cfg,
                                     ncx, ncy, shape)
            (st_next, out), syncs = _host_syncs(torch, step)
            assert bool(out.is_keyframe) == (label == "keyframe"), (label, j)
            # index_add_ sums with atomics on the card: a replay agrees to
            # float rounding, not bit for bit
            assert float(torch.abs(out.t_wc - outs[j - 1].t_wc).max()) \
                < 1e-5, (label, j)
            ops, dms, by, prof = _device_profile(torch, step)
            steps[label] = {"frame": j, "host_syncs": len(syncs),
                            "device_ops": ops, "device_ms": dms,
                            "kernel_device_ms": by}
            print(f"# {preset} {label} step (frame {j}): {len(syncs)} host "
                  f"syncs, {ops} device ops, {dms:.3f} ms device time; "
                  f"kernels {by}" + "".join(f"\n#   {x}" for x in syncs),
                  flush=True)
            assert not syncs, f"{preset} {label} step waits on the card"
            (root / "chiprun_out").mkdir(exist_ok=True)
            (root / "chiprun_out" / f"chip_smoke_profile_{preset}_{label}"
             ".txt").write_text(prof.key_averages().table(
                 sort_by="self_cuda_time_total", row_limit=40))
            st = st_next
        summary = {"frames": n, "median_terr_mm": med, "max_terr_mm": mx,
                   "ms_per_frame": wall / n * 1e3, "keyframes": kf_frames,
                   "launches": launches,
                   "launches_per_frame": {k_: v / n for k_, v in
                                          launches.items()},
                   "steps": steps}
        return summary, outs, snaps

    fast, fast_outs, fast_snaps = run_path("fast")
    accurate, _, acc_snaps = run_path("accurate")
    del acc_snaps

    # --- 6. the CPU path over the window holding the first keyframe --------
    k = fast["keyframes"][0]
    s = max(i for i in fast_snaps if i < k and k <= i + CPU_FRAMES)
    cpu_state = state_from_numpy(state_to_numpy(fast_snaps[s]), device="cpu")
    del fast_snaps
    cfg = cfgs["fast"]
    dpos, kf_cpu, kf_card = 0.0, [], []
    t0 = time.perf_counter()
    for j in range(s + 1, s + CPU_FRAMES + 1):
        cpu_state, out = fused.vo_step(cpu_state, imgs[j - 1].cpu(), cam, cfg,
                                       ncx, ncy, shape)
        card = fast_outs[j - 1]
        assert not bool(out.failed)
        dpos = max(dpos, float(np.abs(out.t_wc.numpy()
                                      - card.t_wc.cpu().numpy()).max()))
        kf_cpu.append(bool(out.is_keyframe))
        kf_card.append(bool(card.is_keyframe))
    cpu_wall = time.perf_counter() - t0
    print(f"# card vs CPU over frames {s + 1}-{s + CPU_FRAMES} (keyframe at "
          f"{k}): max |dt_wc| {dpos:.3e} m (tol {CPU_TOL_M}); keyframes "
          f"equal: {kf_cpu == kf_card}; CPU "
          f"{cpu_wall / CPU_FRAMES * 1e3:.1f} ms/frame", flush=True)
    assert any(kf_cpu) and kf_cpu == kf_card, (kf_cpu, kf_card)
    assert dpos <= CPU_TOL_M, dpos

    # --- 7. the lines --------------------------------------------------------
    paths = {"slice_a": (launches_a, SLICE_A_FRAMES),
             "fast": (fast["launches"], fast["frames"]),
             "accurate": (accurate["launches"], accurate["frames"])}
    for name in ("tile_gather", "sparse_align"):
        for path, (counts, _) in paths.items():
            assert counts[name] > 0, (name, path)

    def by_path(name):
        return ({p: c[name] for p, (c, _) in paths.items()},
                {p: c[name] / n for p, (c, n) in paths.items()})

    def main_ms(name):
        return {p: {lbl: sm["steps"][lbl]["kernel_device_ms"][name]
                    for lbl in ("keyframe", "other")}
                for p, sm in (("fast", fast), ("accurate", accurate))}

    main_k1 = next(s_ for s_ in k1_shapes if s_["use"] == "reproject_fast")
    k2_fast = [r for r in k2_runs if r["n_features"] == 128]
    k1_by, k1_pf = by_path("tile_gather")
    k2_by, k2_pf = by_path("sparse_align")
    kernels = [
        {"name": "tile_gather", "route": "cuda",
         "source": "rpg_svo_tpu_torch/csrc/tile_gather.cu",
         "replaces": "rpg_svo_tpu/ops/pallas_tiles.py:126",
         "launches": fast["launches"]["tile_gather"], "max_abs_err": 0.0,
         "ms": main_k1["ms"], "plain_ms": main_k1["plain_ms"],
         "bound_ms": main_k1["bound_ms"], "bound_by": "bytes",
         "library_ms": main_k1["library_ms"],
         "launches_by_path": k1_by, "launches_per_frame": k1_pf,
         "device_ms_per_step": main_ms("tile_gather"),
         "by_shape": k1_shapes},
        {"name": "sparse_align", "route": "cuda",
         "source": "rpg_svo_tpu_torch/csrc/sparse_align.cu",
         "replaces": "rpg_svo_tpu/ops/pallas_align.py:58",
         "launches": fast["launches"]["sparse_align"], "max_abs_err": k2_err,
         "ms": statistics.median(r["ms"] for r in k2_fast),
         "plain_ms": k2_fast[0]["plain_ms"],
         "bound_ms": statistics.median(r["bound_ms"] for r in k2_fast),
         "bound_by": k2_fast[0]["bound_by"], "library_ms": None,
         "launches_by_path": k2_by, "launches_per_frame": k2_pf,
         "device_ms_per_step": main_ms("sparse_align"),
         "by_trial": k2_runs},
    ]
    summary = {"slice_a": {"frames": SLICE_A_FRAMES,
                           "median_terr_mm": float(np.median(terr_a)) * 1e3,
                           "device_ops_per_step": ops_a,
                           "device_ms_per_step": ms_a},
               "fast": fast, "accurate": accurate,
               "card_vs_cpu": {"frames": [s + 1, s + CPU_FRAMES],
                               "max_dt_m": dpos,
                               "cpu_ms_per_frame":
                                   cpu_wall / CPU_FRAMES * 1e3},
               "seconds": time.perf_counter() - t_start}
    print("# summary " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
