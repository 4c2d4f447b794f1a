#!/usr/bin/env python3
"""Smoke run of the PyTorch and CUDA port (rpg_svo_tpu_torch) on one card.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, and fails (nonzero exit, no result line) without
one, or without the port beside it.  Phases, each fatal on failure:

1. header: the card's name and power limit; build both kernels with nvcc
   and the native image loader with g++, side by side (which image
   decoders the machine has: libpng, PIL);
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
   over frames 1-120 of the bench scene (441-frame circle, radius 0.25 m,
   half a revolution), seeded from frame 0 as ``bench.py::run_preset``
   does: median and max translation error over frames 41-120 within the
   limits, no failed frame, exactly 4 K1 and 1 K2 launches per frame, 0
   host syncs in one keyframe step and one other step, device ops and
   device time of each;
6. the fast step on the CPU (plain twins) over the 20 frames holding the
   first keyframe, from the card's state before them: equal keyframe
   decisions, max |dt_wc| <= 1e-3 m;
7. the host pipeline ``FrameHandler`` (fast), seeded with ground-truth
   depth as ``bench.py::run_preset`` seeds, over frames 1-440: median and
   max translation error over frames 41-440 within the JAX handler's CPU
   figures +10% and +20%, no failed frame; ms/frame with the SVO_TRACE
   stage totals, host syncs per frame (sync debug mode plus the stage
   timers' synchronizes) and device ops and time of the first keyframe
   step and the next, from a replay of the 20 frames holding it;
8. ``FrameHandler`` (accurate) over frames 1-100: no failed frame, the
   first keyframe runs local BA;
9. the ``bench.py --bootstrap`` protocol (fast): ``add_image`` from frame
   0 at stride 5 until the default stage, ``state_from_handler``, then
   ``vo_step`` to frame 440: the bootstrap frame, its inliers and the
   Sim3-aligned ATE median over bench's window within the JAX CPU figure
   +10%;
10. relocalization: a blank frame fails, the next frame relocalizes, then
   ``relocalize_frame_at_pose`` and ``global_ba``;
11. ``FrameHandler`` on the CPU over the replay's 20 frames from the
   card's handler before them: equal results and keyframes, max |dt_wc|
   <= 1e-3 m;
12. (phases 13-17 write their files under build/chip_smoke/, removed at
   the end; they run one after another, as every phase does)
13. ``FrameHandler`` (fast) with the ATAN camera of a ``camera_atan.yaml``
   the smoke writes and loads with ``load_camera_yaml``, on the bench
   scene rendered through it, from ground-truth depth over frames 1-440:
   median and max translation error over frames 41-440 within the JAX
   handler's CPU figures +10% and +20%, no failed frame, no K2 launch
   (the reference aligns non-pinhole cameras with the plain loop), host
   syncs per frame from a replay, the sparse alignment's SVO_TRACE total;
14. the same with the Omni camera of tests/test_cameras.py over frames
   1-OMNI_FRAMES (limits over frames 41-OMNI_FRAMES), then the port's
   handler on the CPU over the same frames from the same start: the first
   frame where the card and the CPU part by more than 1e-4 m, the largest
   gap, and the CPU run's errors within the same limits;
15. the offline driver, blender protocol: the bench scene written in the
   blender layout (PNG written with zlib, depth maps of every 40th frame),
   then ``rpg_svo_tpu_torch.tools.benchmark.main`` with ``--dataset
   blender ... --noise-sigma 1.0 --trace-depth --ply`` in a subprocess
   that counts the kernels' launches over the run: its ATE RMSE within
   the JAX driver's CPU figure on the same files +10%, every output file;
   the driver's own host syncs from a run of its first 30 images here;
16. the offline driver on the EuRoC layout (every 5th frame as PGM,
   decoded by the native prefetcher) from the bootstrap: its Sim3 ATE
   RMSE within the JAX driver's CPU figure +10%; then the experiment YAML
   over the tree's first 60 images, pose for pose equal to that run
   (1e-6), whose run counts the host syncs;
17. checkpoints: the ATAN handler saved at frame 200 and resumed in a
   fresh handler on the card tracks the next 20 frames as the
   uninterrupted run (1e-6 m); the port's CPU handler saved at frame 200
   resumes on the card within 1e-3 m;
18. one JSON line of kernel measurements (launches per frame on every
   path), the card's line, and the result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
import importlib.util
import io
import json
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np

N_FRAMES = 441                 # the bench scene: frame 0 seeds, 1-440 track
SHAPE = (480, 752)
SCENE_KW = dict(trajectory="circle", radius=0.25, revolutions=0.5)
TIMED_FROM = 41                # bench.py's timed frames are 41-440
SLICE_A_FRAMES = 20
CPU_FRAMES = 20
SNAP_EVERY = 20                # states kept for the replays
# translation error limits (mm, median and max over frames 41-440): the
# JAX package's pins (BENCH_r05.json, 2.39/4.34 and 1.89/4.29 mm) plus 10%
# and 20%
LIMITS_MM = {"fast": (2.63, 5.2), "accurate": (2.08, 5.15)}
# frames of phase 5, cut from 440 to keep the smoke within its time budget:
# both presets to the window past their first keyframe (87; phases 7, 9
# and 15 run the fast pipeline over all 440 frames); the limits then hold
# over frames 41-120
PRESET_FRAMES = {"fast": 120, "accurate": 120}
# the host pipeline: the JAX FrameHandler from ground-truth depth over the
# bench scene on the CPU (tests/_torch_port.py jax_reference): 0.48393 mm
# median and 1.33266 mm max over frames 41-440, +10% and +20%
HANDLER_LIMITS_MM = (0.48393 * 1.1, 1.33266 * 1.2)
HANDLER_ACC_FRAMES = 100
# bench.py --bootstrap's protocol: the JAX figure on the CPU (same script):
# bootstrap at frame 165, ATE median 0.16054 mm over frames 166-405, +10%
BOOT_STRIDE = 5
BOOT_CHUNK = 40
BOOT_ATE_LIMIT_MM = 0.16054 * 1.1
RELOC_FROM = 200               # the relocalization phase starts after it
# the bench scene through the ATAN and Omni cameras: the JAX FrameHandler
# from ground-truth depth on the CPU (tests/_torch_port.py
# jax_camera_reference), median and max translation error over frames
# 41-440 (ATAN: 1.98860 / 2.76365 mm) and 41-200 (Omni, which tracks frames
# 1-200 with no failure: 0.92461 / 2.44030 mm), +10% and +20%
ATAN_LIMITS_MM = (1.98860 * 1.1, 2.76365 * 1.2)
OMNI_FRAMES = 200
OMNI_LIMITS_MM = (0.92461 * 1.1, 2.44030 * 1.2)
# the offline driver on the files phases 15 and 16 write: the JAX driver's
# ATE RMSE on the CPU on the same files (tests/_torch_port.py
# jax_driver_reference: 0.42304 mm over 441 poses of the blender protocol,
# Sim3 0.23949 mm over the 56 poses after the EuRoC bootstrap), +10%
DRIVER_ATE_LIMITS_M = {"blender": 0.42304e-3 * 1.1,
                       "euroc": 0.23949e-3 * 1.1}
DRIVER_OUTPUTS = ("traj_estimate.txt", "trace.csv", "translation_error.txt",
                  "orientation_error.txt", "depth_error.txt",
                  "map_points.ply", "report.json")
DRIVER_SYNC_FRAMES = 30        # the in-process run that counts host syncs
DRIVER_FILES = ("benchmark.py:", "trajectory.py:")   # the driver's own syncs
DRIVER_TIMEOUT_S = 600
EXPERIMENT_IMAGES = 60         # the experiment YAML's run on the EuRoC tree
CKPT_AT = 200                  # the ATAN handler is saved after this frame
CKPT_FRAMES = 20
CKPT_TOL_M = 1e-6              # resumed on the card against uninterrupted
TRACE_NAMES = ("pyramid_creation", "sparse_img_align", "reproject_kfs",
               "reproject_candidates", "feature_align", "reproject",
               "pose_optimizer", "point_optimizer", "local_ba")
# card vs CPU trajectory agreement (m) over CPU_FRAMES frames
CPU_TOL_M = 1e-3
# the Omni run on the CPU and on the card: where they part (reported)
SPLIT_M = 1e-4
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


# --- the scenes and files of phases 13-17 -----------------------------------
# (tests/_torch_port.py writes the same files for the JAX package's figures)
# svo_ros/param/camera_atan.yaml's calibration, as tests/test_cameras.py uses
ATAN_YAML = ("cam_model: ATAN\ncam_width: 752\ncam_height: 480\n"
             "cam_fx: 0.511496\ncam_fy: 0.802603\ncam_cx: 0.530199\n"
             "cam_cy: 0.496011\ncam_d0: 0.934479\n")
CAM_PINHOLE = (315.5, 315.5, 376.0, 240.0)
EUROC_STRIDE = 5               # the EuRoC tree holds every 5th bench frame
DEPTH_EVERY = 40               # the blender tree's depth maps: every 40th


def omni_calibration():
    """(poly, inv_poly) of tests/test_cameras.py's Omni camera: the forward
    polynomial chosen, the inverse fitted (as the ocam toolbox does)."""
    poly = np.array([-200.0, 0.0, 1e-3, 0.0, 0.0])
    rho = np.linspace(1e-3, 420.0, 2000)
    theta = np.arctan2(poly[0] + poly[2] * rho ** 2, rho)
    return poly, np.polynomial.polynomial.polyfit(theta, rho, 9)


def to_u8(img) -> np.ndarray:
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)


def write_png(path, img: np.ndarray) -> None:
    """8-bit grayscale PNG with the standard library (zlib, struct)."""
    import struct
    import zlib
    h, w = img.shape

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_pgm(path, img: np.ndarray) -> None:
    """Binary PGM (P5), which the native loader decodes without libpng."""
    h, w = img.shape
    Path(path).write_bytes(f"P5\n{w} {h}\n255\n".encode() + img.tobytes())


def write_blender(root, imgs, t, q, depths) -> None:
    """The blender layout (rpg_svo_tpu_torch/io/datasets.BlenderDataset):
    imgs (N, H, W) uint8, t (N, 3), q (N, 4) xyzw, depths {i: (H, W)}."""
    root = Path(root)
    (root / "img").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(exist_ok=True)
    lines = []
    for i, img in enumerate(imgs):
        name = f"frame_{i:06d}"
        write_png(root / "img" / f"{name}_0.png", img)
        if i in depths:
            np.savetxt(root / "depth" / f"{name}_0.depth",
                       np.asarray(depths[i]).ravel()[None], fmt="%.6f")
        lines.append(f"{name} " + " ".join(repr(float(v)) for v in
                                           (*t[i], *q[i])))
    (root / "trajectory.txt").write_text("\n".join(lines) + "\n")


def write_euroc(root, frames, imgs, t, q) -> None:
    """The EuRoC layout with PGM images: frames (M,) bench frame indices
    of imgs (M, H, W) uint8 at i / 50 s, the ground truth of every frame
    (t (N, 3), q (N, 4) xyzw) in state_groundtruth_estimate0."""
    cam = Path(root) / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True, exist_ok=True)
    rows = ["#timestamp [ns],filename"]
    for i, img in zip(frames, imgs):
        name = f"{i * 20_000_000:019d}.pgm"
        write_pgm(cam / "data" / name, img)
        rows.append(f"{i * 20_000_000},{name}")
    (cam / "data.csv").write_text("\n".join(rows) + "\n")
    gt = Path(root) / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True, exist_ok=True)
    rows = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z"]
    for i in range(len(t)):
        rows.append(",".join([str(i * 20_000_000)] + [repr(float(v)) for v in
                              (*t[i], q[i][3], q[i][0], q[i][1], q[i][2])]))
    gt.joinpath("data.csv").write_text("\n".join(rows) + "\n")


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
    calls of `fn`, from torch.profiler; each call launches one.  The
    profiler may drop an event or two of a run, and now and then every
    event of a run (both seen on the H100): such a run is profiled again,
    at most three times in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and sym in e.name]
        if reps // 2 <= len(us):
            break
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


def _snapshot(fh):
    """The handler as it stands: its tensors are never written in place,
    so a shallow copy (with its own initializer and log) keeps the
    state."""
    h = copy.copy(fh)
    h.initializer = copy.copy(fh.initializer)
    h.log = []
    return h


def _cfg(preset: str):
    """The bench configuration of a preset (bench.py's make_cfg)."""
    from rpg_svo_tpu_torch.config import bench_cfg
    return bench_cfg(preset)


class _Scene(NamedTuple):
    """The bench scene as the handler phases use it: the dataset (its
    texture and poses), the image shape, the device, frame 0's pose and
    the ground-truth positions of frames 1.."""
    ds: object
    shape: tuple
    dev: object
    T0: object
    gt: np.ndarray


def _reset_counts():
    import torch
    from rpg_svo_tpu_torch.ops import align_kernel, tiles
    torch.cuda.synchronize()
    tiles.tile_gather_kernel.launches = 0
    align_kernel.sparse_align_kernel.launches = 0


def _read_counts() -> dict:
    import torch
    from rpg_svo_tpu_torch.ops import align_kernel, tiles
    torch.cuda.synchronize()
    return {"tile_gather": tiles.tile_gather_kernel.launches,
            "sparse_align": align_kernel.sparse_align_kernel.launches}


def _handler_run(scene, cfg, n, camera, frames, first, label):
    """FrameHandler from ground-truth depth (first: frame 0's image and
    depth) over frames 1..n: (summary, infos, positions, snapshots every
    SNAP_EVERY frames)."""
    import torch
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    fh = FrameHandler(camera, cfg, scene.shape, device=scene.dev)
    fh.set_first_frame_with_depth(first[0], scene.T0.inverse(), first[1])
    snaps = {0: _snapshot(fh)}
    infos, pos = [], []
    _reset_counts()
    t0 = time.perf_counter()
    for i in range(1, n + 1):
        infos.append(fh.add_image(frames[i - 1], i / 50.0))
        pos.append(fh.last_frame.T_f_w.inverse().t)
        if i % SNAP_EVERY == 0:
            snaps[i] = _snapshot(fh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    pos = torch.stack(pos).cpu().numpy()
    assert pos.shape == (n, 3) and np.isfinite(pos).all()
    terr = np.linalg.norm(pos - scene.gt[:n], axis=-1)[TIMED_FROM - 1:]
    failed = [i for i, f in enumerate(infos, 1) if f["result"] == "failure"]
    kfs = [i for i, f in enumerate(infos, 1) if f.get("is_keyframe")]
    stage_ms = {k: sum(f.get(k, 0.0) for f in infos) / n * 1e3
                for k in TRACE_NAMES}
    summary = {"frames": n, "median_terr_mm": float(np.median(terr)) * 1e3,
               "max_terr_mm": float(terr.max()) * 1e3,
               "ms_per_frame": wall / n * 1e3,
               "stage_ms_per_frame": stage_ms,
               "timer_syncs_per_frame":
                   sum(f["timer_syncs"] for f in infos) / n,
               "keyframes": kfs, "failed": failed, "launches": launches,
               "launches_per_frame": {k: v / n for k, v in launches.items()}}
    print(f"# FrameHandler {label}: {n} frames, "
          f"{summary['ms_per_frame']:.2f} ms/frame; terr over frames "
          f"{TIMED_FROM}-{n}: median {summary['median_terr_mm']:.4f} mm, "
          f"max {summary['max_terr_mm']:.4f} mm; keyframes {kfs}; failed "
          f"{failed}; launches {launches}; stage ms/frame "
          + json.dumps({k: round(v, 3) for k, v in stage_ms.items()}),
          flush=True)
    assert not failed, f"FrameHandler {label}: frames failed: {failed}"
    assert kfs, f"FrameHandler {label}: no keyframe"
    return summary, infos, pos, snaps


def _sync_replay(snaps, frames, infos, pos, k):
    """Host syncs per frame (sync debug mode plus the stage timers'
    synchronizes) over the CPU_FRAMES frames holding frame k, replayed
    from the snapshot before them; the replay agrees with the run."""
    import torch
    s = max(i for i in snaps if i < k and k <= i + CPU_FRAMES)
    window = range(s + 1, s + CPU_FRAMES + 1)
    h = _snapshot(snaps[s])

    def replay():
        return [(h.add_image(frames[j - 1], j / 50.0),
                 h.last_frame.T_f_w.inverse().t) for j in window]
    out, syncs = _host_syncs(torch, replay)
    for (info, t_wc), j in zip(out, window):
        assert info["result"] == infos[j - 1]["result"], j
        assert float(np.abs(t_wc.cpu().numpy() - pos[j - 1]).max()) < 1e-5
    dbg = len(syncs) / CPU_FRAMES
    tim = sum(i["timer_syncs"] for i, _ in out) / CPU_FRAMES
    return {"frames": [s + 1, s + CPU_FRAMES],
            "debug_mode_syncs_per_frame": dbg,
            "timer_syncs_per_frame": tim,
            "host_syncs_per_frame": dbg + tim,
            "sync_sites": sorted(set(syncs))}


def _camera_run(scene, cfg, camera, label, n, limits):
    """_handler_run over the bench scene rendered through `camera`, with
    the sync replay of the window holding the first keyframe.  Sparse
    alignment runs the plain loop for a non-pinhole camera, as the
    reference dispatches (no K2 launch)."""
    from rpg_svo_tpu_torch.utils.synthetic import render_frame
    ds = scene.ds
    first = render_frame(camera, ds.tex, ds.poses[0], scene.shape)
    frames = [render_frame(camera, ds.tex, ds.poses[i], scene.shape)[0]
              for i in range(1, n + 1)]
    sm, infos, pos, snaps = _handler_run(scene, cfg, n, camera, frames,
                                         first, label)
    import torch
    sm["replay"] = _sync_replay(snaps, frames, infos, pos, sm["keyframes"][0])
    sm["host_syncs_per_frame"] = sm["replay"]["host_syncs_per_frame"]
    # device ops and time of the replay window's first (ordinary) frame
    s = sm["replay"]["frames"][0] - 1
    h = _snapshot(snaps[s])
    ops, dms, by, _ = _device_profile(
        torch, lambda: h.add_image(frames[s], (s + 1) / 50.0))
    sm["step"] = {"frame": s + 1, "device_ops": ops, "device_ms": dms,
                  "kernel_device_ms": by}
    sm["sparse_img_align_total_s"] = \
        sm["stage_ms_per_frame"]["sparse_img_align"] * n / 1e3
    print(f"# {label}: {sm['host_syncs_per_frame']:.2f} host syncs per "
          f"frame ({sm['replay']['debug_mode_syncs_per_frame']:.2f} reads, "
          f"{sm['replay']['timer_syncs_per_frame']:.2f} stage timers); "
          f"launches per frame {sm['launches_per_frame']}; sparse "
          f"alignment {sm['sparse_img_align_total_s']:.3f} s in all; frame "
          f"{s + 1}: {ops} device ops, {dms:.3f} ms device time "
          f"(limits {limits[0]:.4f} / {limits[1]:.4f} mm)", flush=True)
    assert sm["median_terr_mm"] <= limits[0] \
        and sm["max_terr_mm"] <= limits[1], (label, sm, limits)
    assert sm["launches"]["sparse_align"] == 0 \
        and sm["launches"]["tile_gather"] > 0, (label, sm["launches"])
    return sm, pos, snaps, frames


def _cpu_rerun(scene, cfg, camera, frames, card_pos, limits, label):
    """The port's FrameHandler on the CPU over the card's frames (copied)
    from the same start: the first frame where the CPU and the card part
    by more than SPLIT_M, the largest gap, and the CPU run's errors, held
    to the same limits."""
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    from rpg_svo_tpu_torch.utils.synthetic import render_frame
    img0, depth0 = render_frame(camera, scene.ds.tex, scene.ds.poses[0],
                                scene.shape)
    T0 = scene.T0.inverse()
    fh = FrameHandler(camera, cfg, scene.shape, device="cpu")
    fh.set_first_frame_with_depth(img0.cpu(), SE3(T0.R.cpu(), T0.t.cpu()),
                                  depth0.cpu())
    t0 = time.perf_counter()
    pos, failed = [], []
    for i, img in enumerate(frames, 1):
        if fh.add_image(img.cpu(), i / 50.0)["result"] == "failure":
            failed.append(i)
        pos.append(fh.last_frame.T_f_w.inverse().t.numpy())
    wall = time.perf_counter() - t0
    n = len(frames)
    pos = np.stack(pos)
    gap = np.abs(pos - card_pos).max(axis=1)
    split = next((i for i, g in enumerate(gap, 1) if g > SPLIT_M), None)
    terr = np.linalg.norm(pos - scene.gt[:n], axis=-1)[TIMED_FROM - 1:]
    res = {"frames": n, "first_split_frame": split,
           "max_gap_m": float(gap.max()),
           "median_terr_mm": float(np.median(terr)) * 1e3,
           "max_terr_mm": float(terr.max()) * 1e3, "failed": failed,
           "cpu_ms_per_frame": wall / n * 1e3}
    print(f"# {label} on the CPU over the card's frames 1-{n}: first frame "
          f"more than {SPLIT_M} m from the card {split}, largest gap "
          f"{res['max_gap_m']:.3e} m; terr over frames {TIMED_FROM}-{n}: "
          f"median {res['median_terr_mm']:.4f} mm, max "
          f"{res['max_terr_mm']:.4f} mm; failed {failed}; CPU "
          f"{res['cpu_ms_per_frame']:.1f} ms/frame", flush=True)
    assert not failed, (label, failed)
    assert res["median_terr_mm"] <= limits[0] \
        and res["max_terr_mm"] <= limits[1], (label, res, limits)
    return res


def _bench_files(ds):
    """The bench scene's poses (t (N, 3), q (N, 4) xyzw) and 8-bit images,
    as phases 15 and 16 write them."""
    from rpg_svo_tpu_torch.geometry.se3 import rot_to_quat
    t = np.stack([p.t.cpu().numpy() for p in ds.poses])
    q = np.stack([rot_to_quat(p.R).cpu().numpy() for p in ds.poses])
    return t, q, [to_u8(ds.frame(i)[0].cpu().numpy())
                  for i in range(len(ds.poses))]


# the driver as a subprocess, as a user starts it, with the kernels' launch
# counts read inside it: set to 0 just before main() and printed just after
DRIVER_STUB = (
    "import json\n"
    "import torch\n"
    "from rpg_svo_tpu_torch.ops import align_kernel, tiles\n"
    "from rpg_svo_tpu_torch.tools import benchmark\n"
    "tiles.tile_gather_kernel.launches = 0\n"
    "align_kernel.sparse_align_kernel.launches = 0\n"
    "benchmark.main()\n"
    "torch.cuda.synchronize()\n"
    "print('# launches ' + json.dumps({\n"
    "    'tile_gather': tiles.tile_gather_kernel.launches,\n"
    "    'sparse_align': align_kernel.sparse_align_kernel.launches}))\n")


def _driver_syncs(torch, run, n_frames: int) -> dict:
    """Host syncs of a driver run (sync debug mode) per frame of the
    n_frames it is counted over: the driver's own (DRIVER_FILES), and all
    of them (the stage timers' synchronizes aside)."""
    with contextlib.redirect_stdout(io.StringIO()):
        rep, syncs = _host_syncs(torch, run)
    own = [x for x in syncs if x.startswith(DRIVER_FILES)]
    return rep, {"frames": n_frames, "driver_syncs_per_frame": len(own)
                 / n_frames, "all_debug_mode_syncs_per_frame":
                 len(syncs) / n_frames, "driver_sync_sites": sorted(set(own))}


def _blender_phase(root: Path, work: Path, ds, t_all, q_all, u8) -> dict:
    """Phase 15: the bench scene as a blender tree, the driver on it as a
    subprocess (its launches counted there), then the driver's host syncs
    from a run of its first DRIVER_SYNC_FRAMES images in this process."""
    import torch
    from rpg_svo_tpu_torch.tools import benchmark as bench_driver
    t0 = time.perf_counter()
    write_blender(work / "blender", u8, t_all, q_all,
                  {i: ds.frame(i)[1].cpu().numpy()
                   for i in range(0, N_FRAMES, DEPTH_EVERY)})
    write_s = time.perf_counter() - t0
    out_dir = work / "out_blender"

    def argv(frames, out):
        return ["--dataset", "blender", "--path", str(work / "blender"),
                "--frames", str(frames), "--cam",
                ",".join(str(v) for v in CAM_PINHOLE), "--noise-sigma",
                "1.0", "--trace-depth", "--out", str(out)]
    proc = subprocess.run([sys.executable, "-c", DRIVER_STUB,
                           *argv(N_FRAMES, out_dir), "--ply"],
                          cwd=root, capture_output=True, text=True,
                          timeout=DRIVER_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    launches = json.loads(next(x for x in proc.stdout.splitlines()
                               if x.startswith("# launches "))[11:])
    rep = json.loads((out_dir / "report.json").read_text())
    for name in DRIVER_OUTPUTS:
        assert (out_dir / name).is_file(), name
    n_images = rep["frames"] + 1       # frame 0 is seeded from its depth
    # the driver's own syncs over its first images, in this process
    args = bench_driver.parser().parse_args(
        argv(DRIVER_SYNC_FRAMES, work / "out_blender_sync"))
    sync_rep, syncs = _driver_syncs(
        torch, lambda: bench_driver.run(args), DRIVER_SYNC_FRAMES - 1)
    assert sync_rep["frames"] == DRIVER_SYNC_FRAMES - 1, sync_rep["frames"]
    res = {"frames": rep["frames"], "images": n_images, "fps": rep["fps"],
           "wall_s": rep["wall_s"], "write_s": write_s,
           "ms_per_frame": rep["wall_s"] / rep["frames"] * 1e3,
           "ate": rep["ate"], "rpe_delta1": rep["rpe_delta1"],
           "depth_error": rep["depth_error"], "syncs": syncs,
           "launches": launches,
           "launches_per_image": {k: v / n_images
                                  for k, v in launches.items()}}
    print(f"# driver, blender protocol: {rep['frames']} frames, "
          f"fps {rep['fps']}, wall {rep['wall_s']} s (the tree written in "
          f"{write_s:.1f} s); ATE rmse {rep['ate']['rmse'] * 1e3:.4f} mm "
          f"(limit {DRIVER_ATE_LIMITS_M['blender'] * 1e3:.4f}), RPE(1) "
          f"trans rmse {rep['rpe_delta1']['trans_rmse'] * 1e3:.4f} mm, "
          f"depth error p50 {rep['depth_error']['p50'] * 1e3:.3f} mm over "
          f"{rep['depth_error']['n']} features; launches {launches} over "
          f"{n_images} images; the driver's own syncs "
          f"{syncs['driver_syncs_per_frame']:.2f} per frame over frames 1-"
          f"{DRIVER_SYNC_FRAMES - 1} at {syncs['driver_sync_sites']}",
          flush=True)
    assert rep["frames"] == N_FRAMES - 1, rep["frames"]
    assert rep["ate"]["rmse"] <= DRIVER_ATE_LIMITS_M["blender"], rep["ate"]
    assert rep["rpe_delta1"]["n"] > 0 and rep["depth_error"]["n"] > 0
    (root / "chiprun_out" / "chip_smoke_driver_blender_report.json") \
        .write_text(json.dumps(rep, indent=2))
    return res


def _euroc_phase(root: Path, work: Path, shape, t_all, q_all, u8) -> dict:
    """Phase 16: the driver on the EuRoC tree from the bootstrap, then the
    experiment YAML over its first images, whose run counts the host
    syncs."""
    import torch
    from rpg_svo_tpu_torch.tools import benchmark as bench_driver
    sel = list(range(0, N_FRAMES, EUROC_STRIDE))
    write_euroc(work / "euroc", sel, [u8[i] for i in sel], t_all, q_all)
    cam_arg = ",".join(str(v) for v in CAM_PINHOLE)
    args = bench_driver.parser().parse_args([
        "--dataset", "euroc", "--path", str(work / "euroc"), "--frames",
        str(N_FRAMES), "--cam", cam_arg, "--out", str(work / "out_euroc")])
    printed = io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(printed):
        rep = bench_driver.run(args)
    launches = _read_counts()
    source = [x for x in printed.getvalue().splitlines()
              if x.startswith("# image source")]
    traj = np.loadtxt(work / "out_euroc" / "traj_estimate.txt", ndmin=2)
    assert len(traj), "the EuRoC run never left the bootstrap"
    res = {"images": len(sel), "frames": rep["frames"], "fps": rep["fps"],
           "wall_s": rep["wall_s"],
           "ms_per_frame": rep["wall_s"] / rep["frames"] * 1e3,
           "image_source": source,
           "bootstrap_frame": int(round(traj[0, 0] * 50)),
           "ate": rep["ate"], "rpe_delta1": rep.get("rpe_delta1"),
           "launches": launches,
           "launches_per_image": {k: v / len(sel)
                                  for k, v in launches.items()}}
    print(f"# driver, EuRoC layout: {source}; {len(sel)} images, the "
          f"default stage from frame {res['bootstrap_frame']}; fps "
          f"{rep['fps']}, wall {rep['wall_s']} s; Sim3 ATE rmse "
          f"{rep['ate']['rmse'] * 1e3:.4f} mm (limit "
          f"{DRIVER_ATE_LIMITS_M['euroc'] * 1e3:.4f}, scale "
          f"{rep['ate']['scale']:.4f}, {rep['ate']['n']} poses); launches "
          f"{launches}", flush=True)
    assert source and "native prefetcher" in source[0], source
    assert rep["ate"]["rmse"] <= DRIVER_ATE_LIMITS_M["euroc"], rep["ate"]
    (root / "chiprun_out" / "chip_smoke_driver_euroc_report.json") \
        .write_text(json.dumps(rep, indent=2))
    # the experiment protocol over the first EXPERIMENT_IMAGES images of the
    # same tree: the YAML names vo_fast with the driver's grid, the tree's
    # dataset_params.yaml the camera; the same card and configuration
    # track as the run above, pose for pose
    (work / "euroc" / "dataset_params.yaml").write_text(
        "cam0:\n  cam_model: Pinhole\n"
        f"  cam_width: {shape[1]}\n  cam_height: {shape[0]}\n"
        + "".join(f"  cam_{k}: {v}\n" for k, v in zip(
            ("fx", "fy", "cx", "cy"), CAM_PINHOLE)))
    (work / "experiment.yaml").write_text(
        "experiment_label: smoke\nparam_settings: vo_fast\n"
        "dataset: euroc\ngrid_size: 25\n")
    args = bench_driver.parser().parse_args([
        "--experiment", str(work / "experiment.yaml"), "--dataset-dir",
        str(work), "--frames", str(EXPERIMENT_IMAGES), "--out",
        str(work / "out_experiment")])
    exp_rep, res["syncs"] = _driver_syncs(
        torch, lambda: bench_driver.run_experiment(args)["euroc"],
        EXPERIMENT_IMAGES)
    traj_exp = np.loadtxt(work / "out_experiment" / "smoke_euroc"
                          / "traj_estimate.txt", ndmin=2)
    exp_dt = float(np.abs(traj_exp[:, 1:]
                          - traj[:len(traj_exp), 1:]).max())
    res["experiment"] = {"images": EXPERIMENT_IMAGES, "poses": len(traj_exp),
                         "max_dpose": exp_dt, "ate": exp_rep["ate"]}
    print(f"# experiment YAML on the EuRoC tree, {EXPERIMENT_IMAGES} images: "
          f"{len(traj_exp)} poses, max |dt|, |dq| against the run above "
          f"{exp_dt:.3e} (tol {CKPT_TOL_M}); host syncs per image "
          f"{res['syncs']['all_debug_mode_syncs_per_frame']:.2f}, the "
          f"driver's own {res['syncs']['driver_syncs_per_frame']:.2f}",
          flush=True)
    assert np.array_equal(traj_exp[:, 0], traj[:len(traj_exp), 0]) \
        and exp_dt <= CKPT_TOL_M, exp_dt
    return res


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
    from rpg_svo_tpu_torch.analysis.ate import ate_rmse
    from rpg_svo_tpu_torch.core import checkpoint, fused
    from rpg_svo_tpu_torch.core.convert import (
        handler_from_numpy, handler_to_numpy, state_from_numpy,
        state_to_numpy)
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    from rpg_svo_tpu_torch.core.reprojector import attempt_budget
    from rpg_svo_tpu_torch.geometry.cameras import ATANCamera, OmniCamera
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    from rpg_svo_tpu_torch.io.camera_loader import load_camera_yaml
    from rpg_svo_tpu_torch.native import loader as native_loader
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
    phase_s = {}

    def phase(n):
        """Seconds from the start to phase n, printed and kept."""
        phase_s[n] = time.perf_counter() - t_start
        print(f"# phase {n} starts at {phase_s[n]:.1f} s", flush=True)


    # --- 1. build ----------------------------------------------------------
    phase(1)
    t0 = time.perf_counter()
    # the native image loader (g++) builds beside the kernels (nvcc)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(native_loader.build)
        reports = cuda_build.build()
        native_lib = native.result()
    print(f"# built kernels and the native image loader in "
          f"{time.perf_counter() - t0:.1f} s; loader {native_lib} (PNG: "
          f"{'libpng' if native_loader.has_png() else 'none, PGM only'}); "
          f"PIL importable: {importlib.util.find_spec('PIL') is not None}; "
          f"yaml importable: {importlib.util.find_spec('yaml') is not None}",
          flush=True)
    assert native_lib is not None, "the native image loader did not build"
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}")

    shape = SHAPE
    cfgs = {p: _cfg(p) for p in ("fast", "accurate")}
    ds = SyntheticDataset(n_frames=N_FRAMES, shape=shape, device=dev,
                          **SCENE_KW)
    cam = ds.cam
    ncx, ncy = grid_dims(shape[1], shape[0], cfgs["fast"].grid_size)
    C = ncx * ncy
    img0, depth0, T0 = ds.frame(0)
    pad0 = build_padded_pyramid(img0, cfgs["fast"].n_levels_total)

    # --- 2. K1 against its twin at the call-site shapes ---------------------
    phase(2)
    rng = np.random.default_rng(0)
    k1_cases = [("sparse_align_twin", 17, 128, (4, 3, 2)),
                ("ref_patch", 8, 128, (4, 3, 2)),
                ("first_frame", 24, C, (0, 1, 2)),
                ("bootstrap_keyframes", 24, C, (0,))]
    for p, cfg in cfgs.items():
        F = fused.frame_feature_cap(C, cfg.max_fts)
        k1_cases += [
            (f"reproject_{p}", 17,
             attempt_budget(C, F, cfg.reproj_attempt_factor), (0, 1, 2)),
            # FrameHandler's reprojection keeps the default budget factor
            (f"reproject_handler_{p}", 17, attempt_budget(C, F), (0, 1, 2)),
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
    phase(3)
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

    # --- 4. slice A: keyframes and depth filter stubbed ----------------------
    phase(4)
    cfg_a = cfgs["fast"].replace(ablate=("kf", "df"))
    state = seeded["fast"]
    _reset_counts()
    outs = []
    for img in imgs[:SLICE_A_FRAMES]:
        state, out = fused.vo_step(state, img, cam, cfg_a, ncx, ncy, shape)
        outs.append(out)
    launches_a = _read_counts()
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
    phase(5)
    def run_path(preset):
        cfg = cfgs[preset]
        state = seeded[preset]
        snaps = {0: state}
        outs = []
        n = PRESET_FRAMES[preset]
        _reset_counts()
        t0 = time.perf_counter()
        for i, img in enumerate(imgs[:n], start=1):
            state, out = fused.vo_step(state, img, cam, cfg, ncx, ncy, shape)
            outs.append(out)
            if i % SNAP_EVERY == 0:
                snaps[i] = state
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        failed = [i + 1 for i, o in enumerate(outs) if bool(o.failed)]
        kf_frames = [i + 1 for i, o in enumerate(outs)
                     if bool(o.is_keyframe)]
        pos = np.stack([o.t_wc.cpu().numpy() for o in outs])
        assert pos.shape == (n, 3) and np.isfinite(pos).all()
        terr = np.linalg.norm(pos - gt[:n], axis=-1)[TIMED_FROM - 1:]
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
    phase(6)
    k = fast["keyframes"][0]
    s_fused = s = max(i for i in fast_snaps if i < k and k <= i + CPU_FRAMES)
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

    # --- 7. FrameHandler, fast, from ground-truth depth ---------------------
    phase(7)
    scene = _Scene(ds, shape, dev, T0, gt)

    def handler_run(preset, n):
        return _handler_run(scene, cfgs[preset], n, cam, imgs, (img0, depth0),
                            preset)

    handler, h_infos, h_pos, h_snaps = handler_run("fast", len(imgs))
    assert handler["median_terr_mm"] <= HANDLER_LIMITS_MM[0] \
        and handler["max_terr_mm"] <= HANDLER_LIMITS_MM[1], \
        (handler["median_terr_mm"], handler["max_terr_mm"], HANDLER_LIMITS_MM)

    # replay of the 20 frames holding the first keyframe: host syncs per
    # frame, then device ops and time of the keyframe step and the next
    k = handler["keyframes"][0]
    handler["replay"] = _sync_replay(h_snaps, imgs, h_infos, h_pos, k)
    handler["host_syncs_per_frame"] = \
        handler["replay"]["host_syncs_per_frame"]
    s = handler["replay"]["frames"][0] - 1
    window = range(s + 1, s + CPU_FRAMES + 1)
    h = _snapshot(h_snaps[s])
    for j in range(s + 1, k):
        h.add_image(imgs[j - 1], j / 50.0)
    handler["steps"] = {}
    for label, j in (("keyframe", k), ("other", k + 1)):
        ops, dms, by, _ = _device_profile(
            torch, lambda: h.add_image(imgs[j - 1], j / 50.0))
        assert bool(h.log[-1].get("is_keyframe")) == (label == "keyframe")
        handler["steps"][label] = {"frame": j, "device_ops": ops,
                                   "device_ms": dms, "kernel_device_ms": by}
    print(f"# FrameHandler fast replay of frames {s + 1}-{s + CPU_FRAMES}: "
          f"{handler['host_syncs_per_frame']:.2f} host syncs per frame "
          f"({handler['replay']['debug_mode_syncs_per_frame']:.2f} reads, "
          f"{handler['replay']['timer_syncs_per_frame']:.2f} stage timers); "
          f"steps {json.dumps(handler['steps'])}", flush=True)

    # --- 8. FrameHandler, accurate, to the first keyframe and past it ------
    phase(8)
    handler_acc, acc_infos, _, _ = handler_run("accurate", HANDLER_ACC_FRAMES)
    acc_kf = handler_acc["keyframes"][0]
    assert "local_ba" in acc_infos[acc_kf - 1], "no local BA at the keyframe"
    lim = LIMITS_MM["accurate"]
    assert handler_acc["median_terr_mm"] <= lim[0] \
        and handler_acc["max_terr_mm"] <= lim[1], handler_acc

    # --- 9. the bench.py --bootstrap protocol (fast) ------------------------
    phase(9)
    cfg = cfgs["fast"]
    fh = FrameHandler(cam, cfg, shape, device=dev)
    _reset_counts()
    t0 = time.perf_counter()
    fh.add_image(img0, 0.0)
    i, i_boot, n_calls = 0, None, 1
    while i + BOOT_STRIDE < N_FRAMES - 1:
        i += BOOT_STRIDE
        info = fh.add_image(imgs[i - 1], i / 50.0)
        n_calls += 1
        if fh.stage == "default":
            i_boot, inliers = i, info["init_inliers"]
            break
    boot_s = time.perf_counter() - t0
    assert i_boot is not None, "the bootstrap never reached the default stage"
    boot_launches = _read_counts()
    state = fused.state_from_handler(fh)
    _reset_counts()
    b_outs = []
    for j in range(i_boot + 1, N_FRAMES):
        state, out = fused.vo_step(state, imgs[j - 1], cam, cfg, ncx, ncy,
                                   shape)
        b_outs.append(out)
    track_launches = _read_counts()
    est = torch.stack([o.t_wc for o in b_outs]).cpu().numpy()
    b_failed = [i_boot + 1 + q for q, o in enumerate(b_outs)
                if bool(o.failed)]
    n_bench = BOOT_CHUNK + BOOT_CHUNK * (
        (N_FRAMES - 1 - i_boot - BOOT_CHUNK) // BOOT_CHUNK)
    ate_b = ate_rmse(gt[i_boot:i_boot + n_bench], est[:n_bench])
    ate_all = ate_rmse(gt[i_boot:], est)
    bootstrap = {"frame": i_boot, "inliers": inliers, "add_image_calls":
                 n_calls, "seconds": boot_s,
                 "bench_window": [i_boot + 1, i_boot + n_bench],
                 "ate_median_mm": ate_b["median"] * 1e3,
                 "ate_median_mm_to_end": ate_all["median"] * 1e3,
                 "scale": ate_b["scale"], "failed": b_failed,
                 "launches": boot_launches, "launches_per_call":
                 {k_: v / n_calls for k_, v in boot_launches.items()},
                 "track_launches": track_launches,
                 "track_launches_per_frame":
                 {k_: v / len(b_outs) for k_, v in track_launches.items()}}
    print(f"# bootstrap protocol: default stage at frame {i_boot} "
          f"({inliers} inliers, {n_calls} add_image calls, {boot_s:.1f} s); "
          f"ATE median {bootstrap['ate_median_mm']:.4f} mm over frames "
          f"{i_boot + 1}-{i_boot + n_bench} (limit {BOOT_ATE_LIMIT_MM:.4f}), "
          f"{bootstrap['ate_median_mm_to_end']:.4f} mm to frame "
          f"{N_FRAMES - 1}; scale {ate_b['scale']:.4f}; failed {b_failed}; "
          f"launches {boot_launches} then {track_launches}", flush=True)
    assert not b_failed, b_failed
    assert bootstrap["ate_median_mm"] <= BOOT_ATE_LIMIT_MM, bootstrap

    # --- 10. relocalization, relocalize_frame_at_pose, global BA -----------
    phase(10)
    h = _snapshot(h_snaps[RELOC_FROM])
    black = torch.zeros(shape, device=dev)
    _reset_counts()
    r1 = h.add_image(black, 0.0)
    assert r1["result"] == "failure" and h.stage == "relocalizing", r1
    r2 = h.add_image(imgs[RELOC_FROM], 0.0)
    reloc_err = float(np.linalg.norm(
        h.last_frame.T_f_w.inverse().t.cpu().numpy() - gt[RELOC_FROM]))
    assert r2["result"] != "failure" and h.stage == "default", r2
    kf = h.map.kf
    kf_id = int(kf.frame_id[kf.active].max())
    at_pose = h.relocalize_frame_at_pose(
        kf_id, SE3.identity(device=dev), imgs[RELOC_FROM + 1], 0.0)
    at_pose_err = float(np.linalg.norm(
        h.last_frame.T_f_w.inverse().t.cpu().numpy() - gt[RELOC_FROM + 1]))
    assert at_pose and h.stage == "default"
    reloc_launches = _read_counts()
    R_before = h.map.kf.R.clone()
    h.global_ba()
    moved = float(torch.abs(h.map.kf.R - R_before).max())
    assert bool(torch.isfinite(h.map.kf.R).all()) \
        and bool(torch.isfinite(h.map.pt.pos).all())
    relocalization = {"from_frame": RELOC_FROM, "blank": r1["result"],
                      "recovered": r2["result"], "terr_mm": reloc_err * 1e3,
                      "at_pose_kf": kf_id, "at_pose_terr_mm":
                      at_pose_err * 1e3, "launches": reloc_launches,
                      "global_ba_max_dR": moved}
    print(f"# relocalization after frame {RELOC_FROM}: blank frame "
          f"{r1['result']}, next frame {r2['result']} (terr "
          f"{reloc_err * 1e3:.3f} mm); at the pose of keyframe {kf_id}: "
          f"{at_pose} (terr {at_pose_err * 1e3:.3f} mm); global BA moved "
          f"rotations by up to {moved:.2e}; launches {reloc_launches}",
          flush=True)
    assert reloc_err < 0.01 and at_pose_err < 0.01

    # --- 11. FrameHandler on the CPU over the replay's frames --------------
    phase(11)
    cpu_fh = handler_from_numpy(handler_to_numpy(h_snaps[s]), cam,
                                cfgs["fast"], shape, device="cpu")
    del h_snaps
    h_dpos, kf_cpu, kf_card = 0.0, [], []
    t0 = time.perf_counter()
    for j in window:
        info = cpu_fh.add_image(imgs[j - 1].cpu(), j / 50.0)
        assert info["result"] == h_infos[j - 1]["result"], j
        kf_cpu.append(bool(info.get("is_keyframe")))
        kf_card.append(bool(h_infos[j - 1].get("is_keyframe")))
        h_dpos = max(h_dpos, float(np.abs(
            cpu_fh.last_frame.T_f_w.inverse().t.numpy() - h_pos[j - 1]).max()))
    h_cpu_wall = time.perf_counter() - t0
    print(f"# FrameHandler card vs CPU over frames {s + 1}-{s + CPU_FRAMES} "
          f"(keyframe at {k}): max |dt_wc| {h_dpos:.3e} m (tol {CPU_TOL_M}); "
          f"keyframes equal: {kf_cpu == kf_card}; CPU "
          f"{h_cpu_wall / CPU_FRAMES * 1e3:.1f} ms/frame", flush=True)
    assert any(kf_cpu) and kf_cpu == kf_card, (kf_cpu, kf_card)
    assert h_dpos <= CPU_TOL_M, h_dpos

    # --- 13-17 write their files under build/chip_smoke/ -------------------
    work = root / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    decoders = {"native_png": native_loader.has_png(),
                "PIL": importlib.util.find_spec("PIL") is not None,
                "yaml": importlib.util.find_spec("yaml") is not None}
    print(f"# image decoders on this machine: {decoders}", flush=True)
    assert decoders["native_png"] or decoders["PIL"], \
        "no PNG decoder: the blender layout cannot be read"

    # --- 13. FrameHandler with the ATAN camera, from ground-truth depth ----
    phase(13)
    (work / "camera_atan.yaml").write_text(ATAN_YAML)
    atan = load_camera_yaml(str(work / "camera_atan.yaml"))
    assert isinstance(atan, ATANCamera), atan
    handler_atan, atan_pos, atan_snaps, atan_frames = _camera_run(
        scene, cfgs["fast"], atan, "ATAN", len(imgs), ATAN_LIMITS_MM)

    # --- 14. FrameHandler with the Omni camera of tests/test_cameras.py ----
    phase(14)
    poly, inv_poly = omni_calibration()
    omni = OmniCamera.make(shape[1], shape[0], poly, inv_poly,
                           shape[1] / 2.0, shape[0] / 2.0)
    handler_omni, omni_pos, _, omni_frames = _camera_run(
        scene, cfgs["fast"], omni, "Omni", OMNI_FRAMES, OMNI_LIMITS_MM)
    handler_omni["cpu"] = _cpu_rerun(scene, cfgs["fast"], omni, omni_frames,
                                     omni_pos, OMNI_LIMITS_MM, "Omni")
    del omni_frames

    # --- 15. the offline driver, blender protocol, as a subprocess --------
    phase(15)
    t_all, q_all, u8 = _bench_files(ds)
    driver_blender = _blender_phase(root, work, ds, t_all, q_all, u8)

    # --- 16. the offline driver, EuRoC layout, PGM images, bootstrap ------
    phase(16)
    driver_euroc = _euroc_phase(root, work, shape, t_all, q_all, u8)

    # --- 17. checkpoints ------------------------------------------------------
    phase(17)
    def resume(path, device):
        fh = FrameHandler(atan, cfgs["fast"], shape, device=device)
        checkpoint.load_handler(str(path), fh)
        return fh

    def track_on(fh, device):
        """CKPT_FRAMES frames after CKPT_AT; max |t_wc - the uninterrupted
        ATAN run's|."""
        d = 0.0
        for j in range(CKPT_AT + 1, CKPT_AT + CKPT_FRAMES + 1):
            info = fh.add_image(atan_frames[j - 1].to(device), j / 50.0)
            assert info["result"] != "failure", j
            d = max(d, float(np.abs(fh.last_frame.T_f_w.inverse().t.cpu()
                                    .numpy() - atan_pos[j - 1]).max()))
        return d

    checkpoint.save_handler(str(work / "card.npz"), atan_snaps[CKPT_AT])
    _reset_counts()
    dt_card = track_on(resume(work / "card.npz", dev), dev)
    ckpt_launches = _read_counts()
    # the port's CPU handler, from the card's state CPU_FRAMES frames
    # before, tracks to CKPT_AT on the CPU and saves there
    cpu_h = handler_from_numpy(handler_to_numpy(
        atan_snaps[CKPT_AT - CPU_FRAMES]), atan, cfgs["fast"], shape,
        device="cpu")
    for j in range(CKPT_AT - CPU_FRAMES + 1, CKPT_AT + 1):
        assert cpu_h.add_image(atan_frames[j - 1].cpu(), j / 50.0)[
            "result"] != "failure", j
    checkpoint.save_handler(str(work / "cpu.npz"), cpu_h)
    dt_cpu = track_on(resume(work / "cpu.npz", dev), dev)
    ckpt = {"at_frame": CKPT_AT, "frames": CKPT_FRAMES,
            "card_checkpoint_max_dt_m": dt_card,
            "cpu_checkpoint_max_dt_m": dt_cpu, "launches": ckpt_launches,
            "bytes": (work / "card.npz").stat().st_size}
    print(f"# checkpoint of the ATAN handler at frame {CKPT_AT}: resumed on "
          f"the card, max |dt_wc| {dt_card:.3e} m over the next {CKPT_FRAMES}"
          f" frames (tol {CKPT_TOL_M}); the CPU handler's checkpoint resumed "
          f"on the card {dt_cpu:.3e} m (tol {CPU_TOL_M}); "
          f"{ckpt['bytes']} bytes", flush=True)
    assert dt_card <= CKPT_TOL_M, dt_card
    assert dt_cpu <= CPU_TOL_M, dt_cpu
    shutil.rmtree(work)

    # --- 18. the lines -------------------------------------------------------
    phase(18)
    paths = {"slice_a": (launches_a, SLICE_A_FRAMES),
             "fast": (fast["launches"], fast["frames"]),
             "accurate": (accurate["launches"], accurate["frames"]),
             "handler_fast": (handler["launches"], handler["frames"]),
             "handler_accurate": (handler_acc["launches"],
                                  handler_acc["frames"]),
             "bootstrap_handler": (boot_launches, n_calls),
             "bootstrap_vo_step": (track_launches, len(b_outs)),
             "relocalization": (reloc_launches, 3),
             "handler_atan": (handler_atan["launches"],
                              handler_atan["frames"]),
             "handler_omni": (handler_omni["launches"],
                              handler_omni["frames"]),
             "driver_blender": (driver_blender["launches"],
                                driver_blender["images"]),
             "driver_euroc": (driver_euroc["launches"],
                              driver_euroc["images"]),
             "checkpoint_atan": (ckpt_launches, CKPT_FRAMES)}
    # the reference runs K2 for pinhole cameras only (pallas_align.py:53):
    # the ATAN and Omni paths align with the plain loop; the bootstrap's
    # two stages before tracking align nothing
    no_k2 = {"bootstrap_handler", "handler_atan", "handler_omni",
             "checkpoint_atan"}
    for path, (counts, _) in paths.items():
        assert counts["tile_gather"] > 0, ("tile_gather", path)
        assert (counts["sparse_align"] == 0) == (path in no_k2), \
            ("sparse_align", path, counts)

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
               "card_vs_cpu": {"frames": [s_fused + 1, s_fused + CPU_FRAMES],
                               "max_dt_m": dpos,
                               "cpu_ms_per_frame":
                                   cpu_wall / CPU_FRAMES * 1e3},
               "handler_fast": handler, "handler_accurate": handler_acc,
               "bootstrap": bootstrap, "relocalization": relocalization,
               "handler_card_vs_cpu": {"frames": [s + 1, s + CPU_FRAMES],
                                       "max_dt_m": h_dpos,
                                       "cpu_ms_per_frame":
                                           h_cpu_wall / CPU_FRAMES * 1e3},
               "handler_atan": handler_atan, "handler_omni": handler_omni,
               "driver_blender": driver_blender, "driver_euroc": driver_euroc,
               "checkpoint": ckpt,
               "phase_start_s": phase_s,
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
