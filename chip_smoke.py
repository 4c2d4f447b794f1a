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
   device time of each (phases 4-5 run the step's eager body,
   ``fused._vo_step``, out of place and inside ``graphed.disable()``, so
   its jitted stages run eagerly too: the reference of every graphed
   phase, its launches counted by the wrappers);
6. the fast step on the CPU (plain twins) over the 20 frames holding the
   first keyframe, from the card's state before them: equal keyframe
   decisions, max |dt_wc| <= 1e-3 m;
7. the host pipeline ``FrameHandler`` (fast; every stage JAX jits a CUDA
   graph replay, ``core/graphed.jit``), seeded with ground-truth depth as
   ``bench.py::run_preset`` seeds, over frames 1-440: median and
   max translation error over frames 41-440 within the JAX handler's CPU
   figures +10% and +20%, no failed frame; ms/frame with the SVO_TRACE
   stage totals; K1 and K2 launches over the run as counted (the
   wrappers' own launches and each graph replay's recorded ones,
   ``graphed.replayed_launches``), and the profiler's kernel events of
   add_image calls 200-219 profiled inside the run (never more than the
   count; phases 8, 13 and 14 profile their last 20 calls, the driver and
   the live tool 20 of theirs); host syncs per frame (sync debug mode
   plus the stage timers' synchronizes) and device ops and time of the
   first keyframe step and the next, from replays of the 20 frames holding
   it;
8. ``FrameHandler`` (accurate) over frames 1-120: no failed frame, the
   first keyframe runs local BA;
9. the ``bench.py --bootstrap`` protocol (fast): ``add_image`` from frame
   0 at stride 5 until the default stage, ``state_from_handler``, then
   ``vo_step`` (graphed) to frame 440: the bootstrap frame, its inliers
   and the Sim3-aligned ATE median over bench's window within the JAX CPU
   figure +10% (the bootstrap run checked is the second, which replays the
   stage graphs the first captured, counted and profiled); 1 K2 and 1-4
   K1 kernel events per frame over the last 5 (the profiler's), as many
   as counted (``_counted``: a mapping stage's K1 only on the replays that
   ran its IF node);
10. relocalization: a blank frame fails, the next frame relocalizes, then
   ``relocalize_frame_at_pose`` and ``global_ba``;
11. ``FrameHandler`` on the CPU over the replay's 20 frames from the
   card's handler before them: equal results and keyframes, max |dt_wc|
   <= 1e-3 m;
12. (phases 13-18 write their files under build/chip_smoke/, removed at
   the end; they run one after another, as every phase does)
13. ``FrameHandler`` (fast) with the ATAN camera of a ``camera_atan.yaml``
   the smoke writes and loads with ``load_camera_yaml``, on the bench
   scene rendered through it, from ground-truth depth over frames
   1-ATAN_FRAMES (120: the checkpoint phase resumes at 100 and tracks 20
   more): median and max translation error over frames 41-ATAN_FRAMES
   within the JAX handler's CPU figures +10% and +20%, no failed frame,
   no K2 launch (the reference aligns non-pinhole cameras with the plain
   loop), host syncs per frame from a replay, the sparse alignment's
   SVO_TRACE total;
14. the same with the Omni camera of tests/test_cameras.py over frames
   1-OMNI_FRAMES (120; limits over frames 41-OMNI_FRAMES), then the port's
   handler on the CPU over the same frames from the same start: the first
   frame where the card and the CPU part by more than 1e-4 m, the largest
   gap, and the CPU run's errors within the same limits;
15. the offline driver, blender protocol: the bench scene written in the
   blender layout (PNG written with zlib, depth maps of every 40th frame),
   then ``rpg_svo_tpu_torch.tools.benchmark.main`` with ``--dataset
   blender ... --noise-sigma 1.0 --trace-depth --ply`` in a subprocess
   that counts and profiles 20 of its frames: its ATE RMSE within
   the JAX driver's CPU figure on the same files +10%, every output file;
   the driver's own host syncs from a run of its first 30 images here;
16. the offline driver on the EuRoC layout (every 5th frame as PGM,
   decoded by the native prefetcher) from the bootstrap: its Sim3 ATE
   RMSE within the JAX driver's CPU figure +10%; then the experiment YAML
   over the tree's first 60 images, pose for pose equal to that run
   (1e-6), whose run counts the host syncs;
17. checkpoints: the ATAN handler saved at frame 100 and resumed in a
   fresh handler on the card tracks the next 20 frames as the
   uninterrupted run (1e-6 m); the port's CPU handler saved at frame 200
   resumes on the card within 1e-3 m;
18. the live entry point as a user starts it: ``python3 -c LIVE_STUB``
   runs ``rpg_svo_tpu_torch.tools.live.main`` on its synthetic source
   (the bench scene, 441 frames, add_image from frame 0 at stride 1) with
   ``--traj-out``, 20 frames counted and profiled inside: the
   bootstrap frame equal
   to the JAX tool's on the CPU, no failed frame after it, the Sim3 ATE
   median of the TUM output within the JAX figure +10%, ms and launches
   per frame;
19. the public functions off the main path on frames 0 and 5, card
   against the port on the CPU on the same inputs: feature alignment with
   15 iterations (5 bilinear, 10 cubic) on the padded pyramid (K1), a
   FlatPyramid and the raw image, find_match_direct, epipolar_match with
   align_1d, extract_patches, BoundPyramidPool, image_gradients and
   select_top_k (positions to 1e-3 px, discrete results equal); the
   dashboard and the plots do not run here (no matplotlib on the card's
   machine);
20. (run last, after phases 21-26) one JSON line of kernel
   measurements (launches per frame on every path; on the graphed paths
   of phases 9, 21-23, 25 and 26 the profiler's kernel events per
   replayed frame, batched step or call), the card's line, and the
   result;
21. camera streams in one step: ``parallel.streams.vmapped_vo_step``
   (fast, 752x480; one CUDA graph per B, replayed) over 4 streams, stream
   b from phase 5's state after frame 10 b, each tracking its next 20
   frames: no failed frame, each stream within 1e-3 m of its
   single-stream run with equal keyframes, 4 K1 and 1 K2 launches in the
   capture call (the wrappers) and, per replayed batched step, 1 K2 and
   1-4 K1 kernel events (the profiler's) as counted; 4 streams from frames 50-80 over 10 frames,
   keyframe 87 in the last, graphed within 1e-5 m of the eager batched
   step with equal keyframes; no op of the eager batched step takes
   vmap's per-stream fallback; host ms per batched step (the median of 5
   interleaved rounds of 10 replays), stream-frames per second, device
   ops and ms, host aten ops, kernel events, 0 host syncs, slot MB,
   capture s and pool MB at B = 1, 2, 4 and 8, beside one stream's
   graphed ``vo_step`` timed in the same rounds and one round of the
   eager batched step at B = 8; the batched K1 and K2 against their twins
   per stream, with their device times;
22. the mesh programs on NCCL: a subprocess starts a process group of one
   rank on the card (``init_multihost``, ``make_mesh``) and holds
   ``sharded_pose_optimize``, ``sharded_seed_update``,
   ``distributed_ba_solve``, ``multistream_step`` and 5 frames of
   ``vo_step_mesh`` (graphed: its first call runs the step and captures
   it with its NCCL collectives, later calls replay them) to their
   single-device counterparts on the card (1e-6, graphed ``vo_step`` and
   the eager body); collectives logged on the first call only, a
   replay's kernel events (NCCL, copies, K1, K2) beside one of
   ``vo_step``, the mesh in the slot's key; NCCL across GPUs is not run
   (one card);
23. the donated step ``vo_step_donated`` (a CUDA graph on the card: its
   first call for a state's storage runs the step and captures it, later
   calls replay it) in both presets, from a clone of phase 5's state
   before its first keyframe, through that keyframe and 5 frames past it:
   within 1e-5 m of phase 5 at every frame, the same keyframe, 1 K2 and
   1-4 K1 kernel events per frame as counted (the profiler's: the
   wrappers count no replay), 0 host syncs per frame, every state leaf's data pointer
   unchanged, ``vo_scan_donated`` over the window within 1e-5 m of the
   step loop; then the keyframe step and the next by the eager step body
   and by a replay of ``vo_step_donated`` in turns: host ms (the replay's is
   the graph's launch and its device time, no longer the eager donated
   step's dispatch), peak device memory above the input, and device ops
   and device ms of 5 profiles each way in turns (median and range; a
   difference whose ranges overlap is printed as unresolved);
24. stage attribution: the fast step under each code-level stub of
   tools_stage_timing.py (``cfg.ablate``: full, no_align, no_reproject,
   no_pose, no_struct, no_df, no_kf, only_pyr) through
   ``vo_step_donated`` on one state buffer per variant (one graph each),
   set to phase 5's state after frame 10 before each of 3 interleaved
   rounds of 3 warm-up and 10 timed replays: host ms per step (the median
   round; a replay's, so the stubs' host deltas now follow their device
   time), device ms, device ops and K1 and K2 kernel events of one step,
   failed and keyframe counts, each beside full's; finite poses, and no
   K2 kernel where "align" is stubbed;
25. the donated step as one CUDA graph: ``vo_scan_donated`` in both
   presets over frames 1-120 from a clone of the seeded state (frame 1
   captures, the rest replay): within 1e-6 m (fast) and 1e-5 m
   (accurate) of phase 5's eager step at every frame, the same
   keyframes, the limits of phase 5; 0 host syncs over the replayed
   frames; per replayed frame, from the profiler, 1 K2 and 1-4 K1 kernel
   events as counted, under 50 host-side aten ops (eager: ~9k), device ops and
   device ms; capture seconds and the graph's pool MB; host ms per frame
   of the eager body and of replays over frames 1-10, the median of 5
   interleaved rounds (every round printed), and each way's device busy
   share, with graphed ``vo_step`` (a copy into its slot, a replay, a
   copy out) timed in the same rounds;
26. the entries that keep their input as CUDA graphs: every graph and
   slot dropped, then ``vo_scan`` in both presets over frames 1-120 from
   the seeded state (one copy into its slot, frame 1 a capture, the rest
   replays, one copy out): within 1e-6 m (fast) and 1e-5 m (accurate) of
   phase 5 at every frame, the same keyframes, the limits of phase 5, 0
   host syncs, the input state equal to a clone of it, the capture call's
   4 K1 and 1 K2 launches (the wrappers); a second ``vo_scan`` from a
   clone makes no capture and gives the same outputs; per replayed frame
   inside ``vo_scan`` 1 K2 and 1-4 K1 kernel events as counted and under
   50 host aten ops; one ``vo_step`` call: 0 host syncs, 1 K2 and 1-4 K1
   events as counted, under
   250 host aten ops, its copy in and copy out alone (host aten ops and
   device us); slot MB, capture s and pool MB;
27. ``FrameHandler``'s jitted stages as CUDA graphs (``graphed.jit``),
   every graph dropped first: both presets over frames 1-120 with graphs
   and under ``graphed.disable()`` (the eager reference): within 1e-6 m
   (fast) and 1e-5 m (accurate) of each other, the same keyframes and
   results, no capture after the first keyframe, no graph evicted; over
   the 10 frames from the snapshot before the first keyframe, each way:
   host ms per frame (median and range of 5 interleaved rounds), device
   ms and busy share, host aten ops, host syncs (no more graphed than
   eager), K1/K2 launches per frame as counted (equal both ways) and the
   profiler's kernel events (never more); the MB copied into
   and out of the stages per frame and the copies' device time; per
   wrapped function its graphs, captures, input-buffer MB (shared between
   stages) and pool MB.
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
HANDLER_ACC_FRAMES = 120
# bench.py --bootstrap's protocol: the JAX figure on the CPU (same script):
# bootstrap at frame 165, ATE median 0.16054 mm over frames 166-405, +10%
BOOT_STRIDE = 5
BOOT_CHUNK = 40
BOOT_ATE_LIMIT_MM = 0.16054 * 1.1
RELOC_FROM = 200               # the relocalization phase starts after it
# the bench scene through the ATAN and Omni cameras: the JAX FrameHandler
# from ground-truth depth on the CPU (tests/_torch_port.py
# jax_camera_reference), median and max translation error over frames
# 41-120 (ATAN: 0.73859 / 1.12855 mm; Omni: 0.65780 / 1.09444 mm), +10%
# and +20%; both runs stop at frame 120 to keep the smoke near half its
# time limit
ATAN_FRAMES = 120
ATAN_LIMITS_MM = (0.73859 * 1.1, 1.12855 * 1.2)
OMNI_FRAMES = 120
OMNI_LIMITS_MM = (0.65780 * 1.1, 1.09444 * 1.2)
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
# the add_image calls profiled inside the driver's, the live tool's and
# the 440-frame handler's runs (after the bootstraps and the first
# keyframe's captures); the 120-frame handler runs profile their last
# EVENTS_WINDOW
EVENTS_FROM = 200
EVENTS_WINDOW = 20
EUROC_EVENTS_FROM = 50         # the EuRoC run's (89 images)
EXPERIMENT_IMAGES = 60         # the experiment YAML's run on the EuRoC tree
CKPT_AT = 100                  # the ATAN handler is saved after this frame
CKPT_FRAMES = 20               # ATAN_FRAMES = CKPT_AT + CKPT_FRAMES
CKPT_TOL_M = 1e-6              # resumed on the card against uninterrupted
# the live entry point on its synthetic source (the bench scene): the JAX
# tool's CPU run (tests/_torch_port.py jax_live_reference) bootstraps at
# frame 168 with no failure after it, Sim3 ATE median 0.18461 mm over the
# 272 poses after the bootstrap; +10%
LIVE_BOOT_FRAME = 168
LIVE_ATE_LIMIT_MM = 0.18461 * 1.1
LIVE_TIMEOUT_S = 400
# the left-out functions, card against the port on the CPU: positions
# (px), samples (gray levels) and geometry; discrete results exactly
SURFACE_PX_TOL = 1e-3
SURFACE_SAMPLE_TOL = 1e-3
SURFACE_N_ITER = 15            # 5 bilinear iterations, then 10 cubic
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
# detection tiles (each runs every frame of the eager step, its result kept
# on keyframes; a graph replay runs the last three only inside the mapping
# stages' IF nodes, on the frames that run them: ``_counted``)
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
# phase 21: B camera streams in one step (parallel/streams.vmapped_vo_step),
# stream b from the fast run's state after frame STREAM_EVERY * b; each
# tracks STREAM_FRAMES frames against its single-stream run of phase 5
STREAM_EVERY = 10
STREAMS_B = 4
STREAM_FRAMES = 20
STREAM_BS = (1, 2, 4, 8)       # the batch sizes timed
STREAM_WARM = 3                # steps at each B before the timed ones
STREAM_TIMED, STREAM_ROUNDS = 10, 5   # replays per timed block, rounds
STREAM_GRAPH_TOL_M = 1e-5      # graphed batched step against the eager one
MESH_FRAMES = 5                # phase 22: vo_step_mesh frames
DONATED_PAST = 5               # phase 23: frames past the first keyframe
DONATED_TOL_M = 1e-5           # against phase 5 (local BA sums by atomics)
DONATED_TIMED = 3              # phase 23: timed calls of each step each way
DONATED_PROFILES = 5           # phase 23: device profiles of each, in turns
# phase 24: tools_stage_timing.py's code-level stubs (cfg.ablate)
STAGE_VARIANTS = {"full": (), "no_align": ("align",),
                  "no_reproject": ("reproject",), "no_pose": ("pose",),
                  "no_struct": ("struct",), "no_df": ("df",),
                  "no_kf": ("kf",),
                  "only_pyr": ("align", "reproject", "pose", "struct", "df",
                               "kf")}
STAGE_FROM = 10                # from the fast run's state after this frame
STAGE_ROUNDS = 3
STAGE_WARM = 3
STAGE_TIMED = 10
# phase 25: the donated step as a CUDA graph over frames 1-PRESET_FRAMES;
# against phase 5's eager step body: the same kernels in the same order
# (fast), local BA's atomic sums (accurate)
GRAPH_TOL_M = {"fast": 1e-6, "accurate": 1e-5}
GRAPH_PROFILED = 5             # the last frames, profiled
GRAPH_MAX_HOST_OPS = 50        # aten ops dispatched per replayed frame
# aten ops of one call of a graphed entry that keeps its input (vo_step,
# vmapped_vo_step): the replay's 22 plus the copies of ~60 state leaves in
# and out
GRAPH_MAX_CALL_OPS = 250
GRAPH_ROUNDS, GRAPH_TIMED = 5, 10   # host ms: rounds, frames per round
KEPT_AGAIN = 3                 # phase 26: frames of the second vo_scan
HG_FRAMES = 120                # phase 27: FrameHandler frames each way
HG_TOL_M = {"fast": 1e-6, "accurate": 1e-5}   # graphed against eager
HG_WINDOW = 10                 # phase 27: timed frames, from the snapshot
HG_ROUNDS = 5                  # before the first keyframe, in rounds
MESH_TOL = 1e-6                # phase 22: mesh programs against one device
MESH_TIMEOUT_S = 300
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


# --- the live entry point (phase 19) ----------------------------------------
# (tests/_torch_port.py runs the JAX tool on the same arguments)
def live_args(traj_out) -> list:
    """tools/live's arguments of phase 19: its synthetic source with
    N_FRAMES frames is the bench scene (timestamps i / 50)."""
    return ["--source", "synthetic", "--frames", str(N_FRAMES),
            "--traj-out", str(traj_out)]


def live_figures(stdout: str, tum_path, gt_t: np.ndarray) -> dict:
    """The figures of a live run on the bench scene from its status lines
    and TUM file: the frame whose status first shows the default stage
    (the bootstrap), the frames after it without a pose (failures), and
    the Sim3-aligned ATE over the poses after it against gt_t (N, 3)."""
    import re

    from rpg_svo_tpu_torch.analysis.ate import align_umeyama
    stages = [(int(m.group(2)), m.group(1)) for m in
              (re.match(r"^\[\s*(\S+)\] frame\s+(\d+)", ln)
               for ln in stdout.splitlines()) if m]
    boot = next((f for f, s in stages if s == "default"), None)
    assert boot is not None, "the live run never reached the default stage"
    rows = np.loadtxt(tum_path, ndmin=2)
    idx = np.rint(rows[:, 0] * 50.0).astype(int)
    after = idx > boot
    failed = sorted(set(range(boot + 1, len(gt_t))) - set(idx[after]))
    s, R, t = align_umeyama(rows[after, 1:4], gt_t[idx[after]])
    err = np.linalg.norm((s * (R @ rows[after, 1:4].T)).T + t
                         - gt_t[idx[after]], axis=-1)
    return {"frames": len(stages), "bootstrap_frame": boot,
            "failed_after_bootstrap": failed, "poses_after": int(after.sum()),
            "ate_median_mm": float(np.median(err)) * 1e3,
            "ate_rmse_mm": float(np.sqrt(np.mean(err ** 2))) * 1e3,
            "scale": float(s)}


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
    at most five times in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(5):
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


def _graph_us(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """Device time (us) per call of fn: fn captured `reps` times in a CUDA
    graph, the graph replayed and timed with CUDA events (median over
    `replays`); no host work between the launches.  Phases 21 and 26 time
    short device work so (the batched kernels, a state's copies): late in
    the smoke, after its many profiles, the profiler may return no event
    for it at all."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    return statistics.median(times)


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


def _raw_profile(torch, fn):
    """(fn's result, figures) of one call of fn from the profiler's raw
    events (building its event tree takes seconds for a step's ~9k
    kernels): device ops and device ms as ``_device_profile`` counts them,
    the K1 and K2 kernels the card ran (a CUDA graph's replays included,
    which the wrappers' counts never see) and the aten ops dispatched on
    the host."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, _count_events(torch, prof)


def _count_events(torch, prof) -> dict:
    """``_raw_profile``'s figures of a finished profile."""
    dev, host = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(e)
        elif e.name().startswith("aten::"):
            host += 1
    names = [e.name() for e in dev]
    return {"device_ops": len(dev),
                 "device_ms": sum(e.duration_ns() for e in dev) / 1e6,
                 "tile_gather": sum("tile_gather_kernel" in n for n in names),
                 "sparse_align": sum("sparse_align_kernel" in n
                                     for n in names),
                 "nccl_kernels": sum("nccl" in n.lower() for n in names),
                 # the jitted stages' copies in and out (_foreach_copy_)
                 "foreach_copy_ms": sum(
                     e.duration_ns() for e in dev
                     if "multi_tensor_apply" in e.name()) / 1e6,
                 "memcpy": sum("memcpy" in n.lower() for n in names),
                 "host_aten_ops": host}


def _device_totals(torch, fn):
    """(device ops, device ms) of one call of fn (``_raw_profile``)."""
    _, r = _raw_profile(torch, fn)
    return r["device_ops"], r["device_ms"]


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


@contextlib.contextmanager
def _add_image_events(first: int, n: int):
    """Yields a dict that gets ``_raw_profile``'s figures (K1 and K2
    kernel events, device ops and ms, host aten ops) of FrameHandler
    ``add_image`` calls first..first + n - 1 (0-based, counted inside the
    block), profiled as one window, the window's host seconds (and with
    the profiler's start, stop and event reading: ``span_seconds``), its
    K1 and K2 launches as counted (``_run_launches``) and its stage
    captures.  A subprocess (the driver, the live tool) runs it around its
    main()."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from rpg_svo_tpu_torch.core import pipeline
    orig = pipeline.FrameHandler.add_image
    res = {"first_call": first, "frames": 0}
    calls = [0]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def add_image(self, *args, **kwargs):
        i = calls[0]
        calls[0] += 1
        if i == first:
            res["start"] = (_run_launches(), _jit_captures())
            res["t_span"] = time.perf_counter()
            prof.__enter__()
            res["t0"] = time.perf_counter()
        out = orig(self, *args, **kwargs)
        if i == first + n - 1:
            torch.cuda.synchronize()
            res["seconds"] = time.perf_counter() - res.pop("t0")
            prof.__exit__(None, None, None)
            (c0, k0), c1 = res.pop("start"), _run_launches()
            res.update(_count_events(torch, prof), frames=n,
                       captures=_jit_captures() - k0,
                       counted={k: c1[k] - c0[k] for k in c1})
            # the window with the profiler's start, stop and event reading
            # (seconds each on the H100): what a caller leaves out of its
            # unprofiled ms per frame
            res["span_seconds"] = time.perf_counter() - res.pop("t_span")
        return out

    pipeline.FrameHandler.add_image = add_image
    try:
        yield res
    finally:
        pipeline.FrameHandler.add_image = orig
        if "t0" in res:
            prof.__exit__(None, None, None)


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


def _eager_step(state, img, cam, cfg, ncx, ncy, shape):
    """The step's eager body, out of place: what ``vo_step`` runs on the
    CPU, and on the card the reference of its graphs (every op dispatched
    from Python, so the wrappers count every kernel launch): inside
    ``graphed.disable()``, so that its jitted stages run eagerly too."""
    from rpg_svo_tpu_torch.core import fused, graphed
    with graphed.disable():
        return fused._vo_step(state, img, cam, cfg, ncx, ncy, shape,
                              inplace=False)


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
    """Zero the wrappers' launch counts and the graph replays' (with the
    stage graphs' capture and replay counts)."""
    import torch
    from rpg_svo_tpu_torch.core import graphed
    from rpg_svo_tpu_torch.ops import align_kernel, tiles
    torch.cuda.synchronize()
    tiles.tile_gather_kernel.launches = 0
    align_kernel.sparse_align_kernel.launches = 0
    graphed.reset_jit_counts()


def _read_counts() -> dict:
    """The wrappers' own launch counts (no graph replay among them)."""
    import torch
    from rpg_svo_tpu_torch.ops import align_kernel, tiles
    torch.cuda.synchronize()
    return {"tile_gather": tiles.tile_gather_kernel.launches,
            "sparse_align": align_kernel.sparse_align_kernel.launches}


def _run_launches() -> dict:
    """K1 and K2 launches since ``_reset_counts``: the wrappers' own and
    those of graph replays (each replay launches what its capture recorded,
    ``graphed.replayed_launches``)."""
    from rpg_svo_tpu_torch.core import graphed
    rep = graphed.replayed_launches()
    return {k: v + rep.get(k, 0) for k, v in _read_counts().items()}


def _counted(fn):
    """(fn(), the K1 and K2 launches made during fn as ``_run_launches``
    counts them: a graph replay's launches inside a mapping stage's IF
    node only where the node ran, read from the gate counters)."""
    before = _run_launches()
    out = fn()
    after = _run_launches()
    return out, {k: after[k] - before[k] for k in after}


def _jit_captures() -> int:
    from rpg_svo_tpu_torch.core import graphed
    return sum(v["captures"] for v in graphed.jit_stats().values())


def _seen_by_profiler(ev: dict, counted: dict, label) -> dict:
    """The profiler's K1 and K2 events of a run against its counted
    launches: never more; returns the launches it missed."""
    seen = {k: ev[k] for k in counted}
    assert all(seen[k] <= counted[k] for k in counted), (label, seen,
                                                          counted)
    return {k: counted[k] - seen[k] for k in counted}


def _handler_run(scene, cfg, n, camera, frames, first, label, events_from):
    """FrameHandler from ground-truth depth (first: frame 0's image and
    depth) over frames 1..n: (summary, infos, positions, snapshots every
    SNAP_EVERY frames).  The run's K1 and K2 launches are counted over the
    whole run (``_run_launches``: the stages replay CUDA graphs), and
    EVENTS_WINDOW of its add_image calls from ``events_from`` (0-based)
    are profiled inside it; ms per frame leaves that window out, with the
    profiler's start and stop."""
    import torch
    from rpg_svo_tpu_torch.core import spans
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    fh = FrameHandler(camera, cfg, scene.shape, device=scene.dev)
    fh.set_first_frame_with_depth(first[0], scene.T0.inverse(), first[1])
    snaps = {0: _snapshot(fh)}
    infos, pos = [], []
    _reset_counts()
    t0 = time.perf_counter()
    # the stage times come from the handler's spans
    with spans.recording(), \
            _add_image_events(events_from, EVENTS_WINDOW) as ev:
        for i in range(1, n + 1):
            infos.append(fh.add_image(frames[i - 1], i / 50.0))
            pos.append(fh.last_frame.T_f_w.inverse().t)
            if i % SNAP_EVERY == 0:
                snaps[i] = _snapshot(fh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _run_launches()
    assert ev["frames"] == EVENTS_WINDOW, ev
    pos = torch.stack(pos).cpu().numpy()
    assert pos.shape == (n, 3) and np.isfinite(pos).all()
    terr = np.linalg.norm(pos - scene.gt[:n], axis=-1)[TIMED_FROM - 1:]
    failed = [i for i, f in enumerate(infos, 1) if f["result"] == "failure"]
    kfs = [i for i, f in enumerate(infos, 1) if f.get("is_keyframe")]
    stage_ms = {k: sum(f.get(k, 0.0) for f in infos) / n * 1e3
                for k in TRACE_NAMES}
    assert kfs, f"FrameHandler {label}: no keyframe"
    events = {k: ev[k] for k in ("tile_gather", "sparse_align")}
    misses = _seen_by_profiler(ev, ev["counted"], label)
    window = [events_from + 1, events_from + EVENTS_WINDOW]
    summary = {"frames": n, "median_terr_mm": float(np.median(terr)) * 1e3,
               "max_terr_mm": float(terr.max()) * 1e3,
               "ms_per_frame": (wall - ev["span_seconds"])
               / (n - EVENTS_WINDOW) * 1e3,
               "ms_per_frame_with_window": wall / n * 1e3,
               "stage_ms_per_frame": stage_ms,
               "keyframes": kfs, "failed": failed, "launches": launches,
               "launch_frames": n,
               "launches_per_frame": {k: v / n for k, v in launches.items()},
               "window_frames": window, "window_events": events,
               "window_counted": ev["counted"],
               "window_profiler_misses": misses,
               "window_captures": ev["captures"], "event_window": ev}
    print(f"# FrameHandler {label}: {n} frames, "
          f"{summary['ms_per_frame']:.2f} ms/frame outside the profiled "
          f"window; terr over frames {TIMED_FROM}-{n}: median "
          f"{summary['median_terr_mm']:.4f} mm, max "
          f"{summary['max_terr_mm']:.4f} mm; keyframes {kfs}; failed "
          f"{failed}; launches {launches} over the run; frames "
          f"{window[0]}-{window[1]} profiled: kernel events {events}, "
          f"counted {ev['counted']}, {ev['captures']} captures; stage "
          f"ms/frame "
          + json.dumps({k: round(v, 3) for k, v in stage_ms.items()}),
          flush=True)
    assert not failed, f"FrameHandler {label}: frames failed: {failed}"
    return summary, infos, pos, snaps


def _sync_replay(snaps, frames, infos, pos, k):
    """Host syncs per frame (sync debug mode) over the CPU_FRAMES frames
    holding frame k, replayed from the snapshot before them; the replay
    agrees with the run."""
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
    return {"frames": [s + 1, s + CPU_FRAMES],
            "host_syncs_per_frame": len(syncs) / CPU_FRAMES,
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
                                         first, label, n - EVENTS_WINDOW)
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
          f"frame; launches per frame {sm['launches_per_frame']}; sparse "
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


# the driver as a subprocess, as a user starts it: EVENTS_WINDOW add_image
# calls from EVENTS_FROM counted and profiled inside it
DRIVER_STUB = (
    "import json\n"
    "import chip_smoke\n"
    "from rpg_svo_tpu_torch.tools import benchmark\n"
    f"with chip_smoke._add_image_events({EVENTS_FROM}, {EVENTS_WINDOW}) "
    "as ev:\n"
    "    benchmark.main()\n"
    "print('# launches ' + json.dumps(ev))\n")


# tools/live as a subprocess, as a user starts it, counted and profiled
# inside it as the driver is
LIVE_STUB = (
    "import json\n"
    "import sys\n"
    "import time\n"
    "import torch\n"
    "import chip_smoke\n"
    "from rpg_svo_tpu_torch.tools import live\n"
    "t0 = time.perf_counter()\n"
    f"with chip_smoke._add_image_events({EVENTS_FROM}, {EVENTS_WINDOW}) "
    "as ev:\n"
    "    live.main(sys.argv[1:])\n"
    "torch.cuda.synchronize()\n"
    "print('# launches ' + json.dumps(dict(\n"
    "    ev, total_seconds=time.perf_counter() - t0)))\n")


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
    ev = json.loads(next(x for x in proc.stdout.splitlines()
                         if x.startswith("# launches "))[11:])
    assert ev["frames"] == EVENTS_WINDOW, ev
    launches = ev["counted"]
    events = {k: ev[k] for k in launches}
    misses = _seen_by_profiler(ev, launches, "driver_blender")
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
           # the profiled window aside, with the profiler's start and stop
           "ms_per_frame": (rep["wall_s"] - ev["span_seconds"])
           / (rep["frames"] - ev["frames"]) * 1e3,
           "ate": rep["ate"], "rpe_delta1": rep["rpe_delta1"],
           "depth_error": rep["depth_error"], "syncs": syncs,
           "launches": launches, "launch_frames": ev["frames"],
           "events": events, "profiler_misses": misses, "event_window": ev,
           "launches_per_image": {k: v / ev["frames"]
                                  for k, v in launches.items()}}
    print(f"# driver, blender protocol: {rep['frames']} frames, "
          f"fps {rep['fps']}, wall {rep['wall_s']} s (the tree written in "
          f"{write_s:.1f} s); ATE rmse {rep['ate']['rmse'] * 1e3:.4f} mm "
          f"(limit {DRIVER_ATE_LIMITS_M['blender'] * 1e3:.4f}), RPE(1) "
          f"trans rmse {rep['rpe_delta1']['trans_rmse'] * 1e3:.4f} mm, "
          f"depth error p50 {rep['depth_error']['p50'] * 1e3:.3f} mm over "
          f"{rep['depth_error']['n']} features; launches {launches}, "
          f"kernel events {events} over {ev['frames']} frames from call "
          f"{EVENTS_FROM} ({ev['captures']} captures); "
          f"{res['ms_per_frame']:.2f} ms/frame outside them; the driver's "
          f"own syncs "
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
    with contextlib.redirect_stdout(printed), \
            _add_image_events(EUROC_EVENTS_FROM, EVENTS_WINDOW) as ev:
        rep = bench_driver.run(args)
    assert ev["frames"] == EVENTS_WINDOW, ev
    launches = ev["counted"]
    events = {k: ev[k] for k in launches}
    misses = _seen_by_profiler(ev, launches, "driver_euroc")
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
           "launches": launches, "launch_frames": ev["frames"],
           "events": events, "profiler_misses": misses, "event_window": ev,
           "launches_per_image": {k: v / ev["frames"]
                                  for k, v in launches.items()}}
    print(f"# driver, EuRoC layout: {source}; {len(sel)} images, the "
          f"default stage from frame {res['bootstrap_frame']}; fps "
          f"{rep['fps']}, wall {rep['wall_s']} s; Sim3 ATE rmse "
          f"{rep['ate']['rmse'] * 1e3:.4f} mm (limit "
          f"{DRIVER_ATE_LIMITS_M['euroc'] * 1e3:.4f}, scale "
          f"{rep['ate']['scale']:.4f}, {rep['ate']['n']} poses); launches "
          f"{launches}, kernel events {events} over {ev['frames']} frames "
          f"from call {EUROC_EVENTS_FROM} ({ev['captures']} captures)",
          flush=True)
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



def _live_phase(root: Path, work: Path, t_all: np.ndarray) -> dict:
    """Phase 18: ``python3 -c LIVE_STUB`` with live_args, the synthetic
    source of N_FRAMES bench frames: the bootstrap frame, no failure after
    it, the Sim3 ATE median, launches and ms per frame."""
    tum = work / "live_tum.txt"
    proc = subprocess.run([sys.executable, "-c", LIVE_STUB,
                           *live_args(tum)], cwd=root, capture_output=True,
                          text=True, timeout=LIVE_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    ev = json.loads(next(x for x in proc.stdout.splitlines()
                         if x.startswith("# launches "))[11:])
    assert ev["frames"] == EVENTS_WINDOW, ev
    counts = ev["counted"]
    events = {k: ev[k] for k in counts}
    misses = _seen_by_profiler(ev, counts, "live")
    seconds = ev["total_seconds"]
    fig = live_figures(proc.stdout, tum, t_all)
    res = dict(fig, seconds=seconds, launches=counts,
               launch_frames=ev["frames"], events=events,
               profiler_misses=misses, event_window=ev,
               # the profiled window aside, with the profiler's start and stop
               ms_per_frame=(seconds - ev["span_seconds"])
               / (fig["frames"] - ev["frames"]) * 1e3,
               launches_per_frame={k: v / ev["frames"]
                                   for k, v in counts.items()})
    (root / "chiprun_out" / "chip_smoke_live_stdout.txt").write_text(
        proc.stdout)
    print(f"# live, synthetic source: {fig['frames']} frames in "
          f"{seconds:.1f} s ({res['ms_per_frame']:.1f} ms/frame); bootstrap "
          f"at frame {fig['bootstrap_frame']} (JAX {LIVE_BOOT_FRAME}), "
          f"failed after it {fig['failed_after_bootstrap']}; Sim3 ATE median "
          f"{fig['ate_median_mm']:.4f} mm over {fig['poses_after']} poses "
          f"(limit {LIVE_ATE_LIMIT_MM:.4f}), scale {fig['scale']:.4f}; "
          f"launches {counts}, kernel events {events} over {ev['frames']} "
          f"frames from call {EVENTS_FROM} ({ev['captures']} captures), per "
          f"frame {res['launches_per_frame']}",
          flush=True)
    assert fig["frames"] == N_FRAMES, fig["frames"]
    assert fig["bootstrap_frame"] == LIVE_BOOT_FRAME, fig
    assert not fig["failed_after_bootstrap"], fig
    assert fig["ate_median_mm"] <= LIVE_ATE_LIMIT_MM, fig
    assert counts["tile_gather"] > 0 and counts["sparse_align"] > 0, counts
    return res


def _surface_phase(ds, dev) -> dict:
    """Phase 19: the public functions off the main path on frames 0 and 5
    of the bench scene, on ``dev`` against the port on the CPU on the same
    inputs: feature alignment with SURFACE_N_ITER iterations on the padded
    pyramid (K1), a FlatPyramid and the raw image; find_match_direct;
    epipolar_match with align_1d; extract_patches, BoundPyramidPool,
    image_gradients and select_top_k.  Returns the launches of the kernel
    paths (feature alignment on the padded pyramid, the epipolar match) and
    the largest differences."""
    import torch
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    from rpg_svo_tpu_torch.ops import detector, feature_align, interp, matcher
    from rpg_svo_tpu_torch.ops.pyramid import build_padded_pyramid
    from rpg_svo_tpu_torch.ops.tiles import PaddedPyramid
    cpu = torch.device("cpu")
    img0, depth0, T0 = ds.frame(0)
    img1, _, T1 = ds.frame(5)
    pads = {dev: [build_padded_pyramid(im, 5) for im in (img0, img1)]}
    pads[cpu] = [PaddedPyramid.from_stack(p.stack.cpu(), p.shapes)
                 for p in pads[dev]]
    rng = np.random.default_rng(19)
    worst = {}

    def agree(name, card, host, tol):
        """card and CPU results equal (tol 0: exactly) or within tol."""
        c, h = card.cpu().numpy(), host.numpy()
        assert c.shape == h.shape and c.dtype == h.dtype, (name, c.shape)
        if tol == 0:
            assert np.array_equal(c, h), name
            return
        fin = np.isfinite(h)
        assert np.array_equal(fin, np.isfinite(c)), name
        d = float(np.abs(c[fin] - h[fin]).max()) if fin.any() else 0.0
        worst[name] = max(worst.get(name, 0.0), d)
        assert d <= tol, (name, d, tol)

    def both(fn):
        """fn(device) on the card and on the CPU, with the card call's
        kernel events: its jitted functions replay CUDA graphs, so a first
        call captures them, and the second, profiled, is the call whose
        result is compared."""
        fn(dev)
        card, ev = _raw_profile(torch, lambda: fn(dev))
        return card, fn(cpu), {k: ev[k] for k in ("tile_gather",
                                                   "sparse_align")}

    # feature alignment: mixed 1-D/2-D items on levels 0-2 (0 for the raw
    # image), bordered patches cut at px, starts up to 2.5 px away
    levels = pads[cpu][1].levels()

    def align_inputs(n_levels, n=256):
        lv = rng.integers(0, n_levels, n).astype(np.int32)
        shp = np.asarray([tuple(l.shape) for l in levels])[lv]
        px = rng.uniform([12, 12], shp[:, ::-1] - 12).astype(np.float32)
        patches = torch.zeros((n, 100))
        for l in range(n_levels):
            sel = torch.from_numpy(lv == l)
            patches[sel] = feature_align.extract_patch_with_border(
                levels[l], torch.from_numpy(px)[sel])[0]
        ang = rng.uniform(0, 2 * np.pi, n)
        return {"patches": patches,
                "start": torch.from_numpy(
                    (px + rng.uniform(-2.5, 2.5, (n, 2))).astype(np.float32)),
                "valid": torch.from_numpy(rng.random(n) > 0.1),
                "is_1d": torch.from_numpy(rng.random(n) < 0.3),
                "direction": torch.from_numpy(np.stack(
                    [np.cos(ang), np.sin(ang)], -1).astype(np.float32)),
                "level": torch.from_numpy(lv)}

    def align(src, a, d):
        t = {k: v.to(d) for k, v in a.items()}
        img = {"padded": pads[d][1],
               "flat": interp.FlatPyramid.from_levels(
                   [l.to(d) for l in levels]),
               "raw": levels[0].to(d)}[src]
        return feature_align.align_features(
            img, t["patches"], t["start"], t["valid"],
            n_iter=SURFACE_N_ITER, level=None if src == "raw" else t["level"],
            direction=t["direction"], is_1d=t["is_1d"])

    launches = {}
    for src in ("padded", "flat", "raw"):
        a = align_inputs(1 if src == "raw" else 3)
        (pc, cc), (ph, ch), counts = both(functools.partial(align, src, a))
        if src == "padded":
            launches["align_padded"] = counts
        agree(f"align_{src}.converged", cc, ch, 0)
        agree(f"align_{src}.px", pc, ph, SURFACE_PX_TOL)
        assert ch.float().mean() > 0.5, src

    # the matcher: frame 0's corners with ground-truth depth in frame 5
    lv0 = [l.cpu() for l in pads[cpu][0].levels()]
    ncx, ncy = detector.grid_dims(SHAPE[1], SHAPE[0], 25)
    feats = detector.detect_features(lv0, torch.zeros(ncx * ncy,
                                                      dtype=torch.bool), 25)
    cam = ds.cam
    Tcr = T1.inverse() * T0
    Tcr = SE3(Tcr.R.cpu(), Tcr.t.cpu())
    f = cam.cam2world(feats["px"])
    d0 = depth0.cpu()
    xi = feats["px"][:, 0].long().clamp(0, SHAPE[1] - 1)
    yi = feats["px"][:, 1].long().clamp(0, SHAPE[0] - 1)
    dep = d0[yi, xi]
    px_gt = cam.world2cam(Tcr.apply(f * dep[:, None]))
    valid = feats["valid"] & torch.isfinite(dep) \
        & cam.is_in_frame(px_gt, boundary=10.0)
    m = {"px": feats["px"], "f": f, "lv": feats["level"], "d": dep,
         "init": px_gt + torch.tensor([2.0, -1.5]), "valid": valid,
         "ftype": torch.from_numpy(
             (rng.random(len(dep)) < 0.4).astype(np.int32))}
    ang = rng.uniform(0, 2 * np.pi, len(dep))
    m["grad"] = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1)
                                 .astype(np.float32))

    def direct(d):
        t = {k: v.to(d) for k, v in m.items()}
        T_ = SE3(Tcr.R.to(d), Tcr.t.to(d))
        return matcher.find_match_direct(
            interp.FlatPyramid.from_levels([l.to(d) for l in levels]),
            interp.FlatPyramid.from_levels([l.to(d) for l in lv0]), cam, T_,
            t["px"], t["f"], t["lv"], t["d"], t["init"], t["valid"],
            n_iter=SURFACE_N_ITER, ftr_type=t["ftype"], ftr_grad=t["grad"])

    dc, dh, _ = both(direct)
    for k in ("level_cur", "success"):
        agree(f"find_match_direct.{k}", getattr(dc, k), getattr(dh, k), 0)
    agree("find_match_direct.px_cur", dc.px_cur, dh.px_cur, SURFACE_PX_TOL)
    assert int(dh.success.sum()) > 0.4 * int(valid.sum())

    def epipolar(d):
        t = {k: v.to(d) for k, v in m.items()}
        T_ = SE3(Tcr.R.to(d), Tcr.t.to(d))
        return matcher.epipolar_match(
            pads[d][1], pads[d][0], cam, T_, t["px"], t["f"], t["lv"],
            t["d"], 0.7 * t["d"], 1.4 * t["d"], t["valid"],
            n_iter=SURFACE_N_ITER, ftr_type=t["ftype"], ftr_grad=t["grad"],
            align_1d=True)

    ec, eh, launches["epipolar_align_1d"] = both(epipolar)
    for k in ("level_cur", "success", "scanned"):
        agree(f"epipolar_match.{k}", getattr(ec, k), getattr(eh, k), 0)
    ok = eh.success
    assert int(ok.sum()) > len(ok) // 4
    agree("epipolar_match.px_cur", ec.px_cur[ok.to(dev)], eh.px_cur[ok],
          SURFACE_PX_TOL)

    # samplers, gradients and the top-k selection
    c = torch.from_numpy(rng.uniform([-6, -6], [SHAPE[1] + 6, SHAPE[0] + 6],
                                     (512, 2)).astype(np.float32))
    pc, ph = (interp.extract_patches(levels[0].to(d), c.to(d), 4, 1)
              for d in (dev, cpu))
    agree("extract_patches.valid", pc[1], ph[1], 0)
    agree("extract_patches", pc[0], ph[0], SURFACE_SAMPLE_TOL)
    pool = torch.stack([torch.cat([l.reshape(-1) for l in ls])
                        for ls in (lv0, levels)])
    shapes = [tuple(l.shape) for l in lv0]
    idx = torch.from_numpy(rng.integers(-1, 3, 512).astype(np.int32))
    lvl = torch.from_numpy(rng.integers(0, 5, 512).astype(np.int32))
    xy = (c / torch.exp2(lvl.float())[:, None])[:, None, :] \
        + torch.from_numpy(rng.uniform(-2, 2, (512, 9, 2))
                           .astype(np.float32))
    bc, bh = (interp.BoundPyramidPool(pool.to(d), shapes, idx.to(d))
              .bilinear(lvl.to(d)[:, None], xy.to(d)) for d in (dev, cpu))
    agree("BoundPyramidPool.valid", bc[1], bh[1], 0)
    agree("BoundPyramidPool.bilinear", bc[0], bh[0], SURFACE_SAMPLE_TOL)
    for k, (gc, gh) in enumerate(zip(interp.image_gradients(
            levels[0].to(dev)), interp.image_gradients(levels[0]))):
        agree(f"image_gradients.{'xy'[k]}", gc, gh, SURFACE_SAMPLE_TOL)
    scores = torch.from_numpy(rng.integers(0, 8, 4096).astype(np.float32))
    keep = torch.from_numpy(rng.random(4096) > 0.3)
    agree("select_top_k", detector.select_top_k(scores.to(dev),
                                                keep.to(dev), 300),
          detector.select_top_k(scores, keep, 300), 0)
    print(f"# left-out functions, card against CPU: largest differences "
          f"{json.dumps(worst)}; launches {launches}", flush=True)
    return {"max_abs_diff": worst, "launches": launches}

def _kernel_counts(prof) -> dict:
    """Launches of each kernel in a profile, by the profiler's own
    events."""
    import torch
    ev = [e.name for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"tile_gather": sum("tile_gather_kernel" in n for n in ev),
            "sparse_align": sum("sparse_align_kernel" in n for n in ev)}


def _streams_phase(snaps, imgs, fast_outs, cam, cfg, grid, shape) -> dict:
    """Phase 21: B camera streams in one step on the card, the batched step
    a CUDA graph per B (its first call captures, later calls replay).
    Stream b starts from the fast run's state after frame STREAM_EVERY *
    b.  First the batched K1 and K2 against their twins per stream; then B
    = STREAMS_B over STREAM_FRAMES frames against each stream's
    single-stream run (phase 5), a batch of B holding the first keyframe
    graphed against the eager batched step, the ops of the eager batched
    step taking vmap's per-stream fallback, and host ms per replayed
    batched step, device ops, kernel events, host aten ops, slot and pool
    MB at every B of STREAM_BS, beside one stream's graphed ``vo_step``
    and one round of the eager batched step at the largest B."""
    import torch
    from rpg_svo_tpu_torch.core import fused, graphed
    from rpg_svo_tpu_torch.core.map import TYPE_DELETED
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    from rpg_svo_tpu_torch.ops import align_kernel, tiles
    from rpg_svo_tpu_torch.ops.pyramid import build_padded_pyramid
    from rpg_svo_tpu_torch.ops.sparse_align import sparse_img_align_plain
    from rpg_svo_tpu_torch.parallel import streams
    ncx, ncy = grid
    t_phase = time.perf_counter()

    def start(B):
        return streams.stack_states([snaps[STREAM_EVERY * b]
                                     for b in range(B)])

    def frames(B, j):
        """Stream b's image of batched step j: frame STREAM_EVERY*b+1+j."""
        return torch.stack([imgs[STREAM_EVERY * b + j] for b in range(B)])

    def step(st, B, j):
        return streams.vmapped_vo_step(st, frames(B, j), cam, cfg, ncx, ncy,
                                       shape)

    def advance(st, c, j):
        """The state after step j of config c: B streams batched (graphed),
        one stream (frame 1 + j) by graphed vo_step for "one", the eager
        batched step at the largest B for "eager"."""
        if c == "one":
            return fused.vo_step(st, imgs[j], cam, cfg, ncx, ncy, shape)[0]
        if c == "eager":
            B = max(STREAM_BS)
            return streams._vmapped_step(st, frames(B, j), cam, cfg, ncx,
                                         ncy, shape)[0]
        return step(st, c, j)[0]

    # --- the batched kernels against their twins, per stream, first: the
    # profiler's kernel times are steadiest before the many profiles below
    B = STREAMS_B
    states = [snaps[STREAM_EVERY * b] for b in range(B)]
    st = streams.stack_states(states)
    shapes = states[0].pad.shapes
    rng = np.random.default_rng(21)
    n = 256
    lv = rng.integers(0, 3, (B, n)).astype(np.int32)
    W = np.asarray([w for _, w in shapes])[lv]
    H = np.asarray([h for h, _ in shapes])[lv]
    dev = st.R.device
    req = [torch.from_numpy(a).to(dev) for a in (
        lv, rng.integers(-20, W + 20).astype(np.int32),
        rng.integers(-20, H + 20).astype(np.int32))]

    def k1():
        return torch.func.vmap(lambda s, l, x, y: tiles.gather_tiles(
            tiles.PaddedPyramid(s, shapes), l, x, y, 17, 17))(
                st.pad.stack, *req)
    tk, xk, yk = k1()
    for b in range(B):
        tp, xp, yp = tiles.gather_tiles_plain(
            states[b].pad, req[0][b], req[1][b], req[2][b], 17, 17)
        assert torch.equal(tk[b], tp) and torch.equal(xk[b], xp) \
            and torch.equal(yk[b], yp), f"batched K1 differs, stream {b}"
    k1_us = _graph_us(torch, k1)

    curs = torch.stack([build_padded_pyramid(imgs[STREAM_EVERY * b],
                                             cfg.n_levels_total).stack
                        for b in range(B)])
    feats = []
    for s_ in states:
        pid = torch.clamp(s_.feat_point, 0).long()
        depth = torch.linalg.vector_norm(
            SE3(s_.R, s_.t).apply(s_.m.pt.pos[pid]), dim=-1)
        ok = s_.feat_valid & (s_.feat_point >= 0) \
            & (s_.m.pt.ptype[pid] != TYPE_DELETED)
        feats.append((s_.feat_px, s_.feat_f, depth, ok))
    feats = [torch.stack(x) for x in zip(*feats)]
    lvl = (cfg.klt_max_level, cfg.klt_min_level, cfg.img_align_n_iter,
           cfg.img_align_eps)
    ident = SE3.identity(device=dev)

    def one(ref, cur, px, f, d, v):
        return align_kernel.sparse_align_kernel(
            tiles.PaddedPyramid(ref, shapes), tiles.PaddedPyramid(cur, shapes),
            cam, ident, px, f, d, v, *lvl)

    def k2():
        return torch.func.vmap(one)(st.pad.stack, curs, *feats)
    Tk, nk, _, _, ik = k2()
    k2_err = 0.0
    for b in range(B):
        rp = sparse_img_align_plain(
            states[b].pad, tiles.PaddedPyramid(curs[b], shapes), cam, ident,
            *[x[b] for x in feats], *lvl, gather=tiles.gather_tiles_plain)
        dtb = float(torch.abs(Tk.t[b] - rp.T_cur_ref.t).max())
        dR = float(torch.abs(Tk.R[b] - rp.T_cur_ref.R).max())
        assert dtb < K2_TOL and dR < K2_TOL \
            and int(nk[b]) == int(rp.n_tracked) \
            and torch.equal(ik[b].cpu(), rp.iters.cpu()), \
            f"batched K2 differs from its twin, stream {b}: {dtb} {dR}"
        k2_err = max(k2_err, dtb, dR)
    k2_us = _graph_us(torch, k2)
    k2_us_1 = _graph_us(torch, lambda: one(
        st.pad.stack[0], curs[0], *[x[0] for x in feats]))
    print(f"# batched kernels, {B} streams: K1 17x17x{n} per stream "
          f"bit-exact, device {k1_us:.2f} us per launch; K2 at N="
          f"{feats[0].shape[1]} within {k2_err:.2e} of the twin per stream, "
          f"equal counts and iterations, device {k2_us:.2f} us per launch "
          f"(one stream: {k2_us_1:.2f} us); CUDA-graph replays",
          flush=True)
    # --- B streams over STREAM_FRAMES frames against their single runs:
    # the first step makes B's slot and captures its graph (the wrappers
    # count that call's eager step), the rest replay (profiler events) ----
    B = STREAMS_B
    _reset_counts()
    st, o0 = step(start(B), B, 0)
    launches = _read_counts()
    slot_b = graphed.slots()[-1]

    def steps(st, B, j0, j1):
        outs = []
        for j in range(j0, j1):
            st, o = step(st, B, j)
            outs.append(o)
        return st, outs
    ((st, rest), ev), replay_want = _counted(lambda: _raw_profile(
        torch, lambda: steps(st, B, 1, STREAM_FRAMES)))
    outs = [o0] + rest
    replay_events = {k: ev[k] for k in ("tile_gather", "sparse_align")}
    t_wc = torch.stack([o.t_wc for o in outs]).cpu().numpy()   # (T, B, 3)
    kf = torch.stack([o.is_keyframe for o in outs]).cpu().numpy()
    failed = torch.stack([o.failed for o in outs]).cpu().numpy()
    dt, kf_equal, kf_frames = 0.0, True, {}
    for b in range(B):
        first = STREAM_EVERY * b
        single = fast_outs[first:first + STREAM_FRAMES]
        ref = np.stack([o.t_wc.cpu().numpy() for o in single])
        ref_kf = [bool(o.is_keyframe) for o in single]
        dt = max(dt, float(np.abs(t_wc[:, b] - ref).max()))
        kf_equal &= ref_kf == [bool(x) for x in kf[:, b]]
        kf_frames[b] = [first + 1 + j for j in range(STREAM_FRAMES)
                        if kf[j, b]]
    print(f"# streams: {B} streams x {STREAM_FRAMES} frames in one graphed "
          f"vmapped step each (the first a capture of {slot_b[2]:.2f} s, "
          f"slot {slot_b[1]:.1f} MB, pool {slot_b[3]:.1f} MB): max |dt_wc| "
          f"against the single-stream runs {dt:.3e} m (tol {CPU_TOL_M}); "
          f"keyframes equal: {kf_equal} {kf_frames}; failed "
          f"{int(failed.sum())}; wrapper launches of the capture call "
          f"{launches}; kernel events over the {STREAM_FRAMES - 1} replays "
          f"{replay_events}", flush=True)
    assert not failed.any(), "streams: a frame failed"
    assert kf_equal and dt <= CPU_TOL_M, (dt, kf_frames)
    assert launches == {"tile_gather": K1_PER_FRAME, "sparse_align": 1}, \
        launches
    assert replay_events == replay_want \
        and replay_want["sparse_align"] == STREAM_FRAMES - 1 \
        and replay_want["tile_gather"] <= K1_PER_FRAME * (STREAM_FRAMES - 1), \
        (replay_events, replay_want)

    # --- a keyframe inside the batch: B streams from frames 50-80 over the
    # next STREAM_EVERY frames, the first keyframe (87) in the last;
    # graphed against the eager batched step and against the single runs --
    kb = [STREAM_EVERY * (max(STREAM_BS) - B + 1 + i) for i in range(B)]
    kb_want = {k: [k + 1 + j for j in range(STREAM_EVERY)
                   if bool(fast_outs[k + j].is_keyframe)] for k in kb}
    kb_res = {}
    for way, fn in (("graphed", streams.vmapped_vo_step),
                    ("eager", streams._vmapped_step)):
        sk = streams.stack_states([snaps[k] for k in kb])
        kf_outs = []
        for j in range(STREAM_EVERY):
            sk, o = fn(sk, torch.stack([imgs[k + j] for k in kb]), cam, cfg,
                       ncx, ncy, shape)
            kf_outs.append(o)
        kb_t = torch.stack([o.t_wc for o in kf_outs]).cpu().numpy()
        kb_kf = torch.stack([o.is_keyframe for o in kf_outs]).cpu().numpy()
        kb_res[way] = {
            "t_wc": kb_t,
            "keyframes": {k: [k + 1 + j for j in range(STREAM_EVERY)
                              if kb_kf[j, i]] for i, k in enumerate(kb)},
            "max_dt_m": max(float(np.abs(kb_t[:, i] - np.stack(
                [o.t_wc.cpu().numpy() for o in
                 fast_outs[k:k + STREAM_EVERY]])).max())
                for i, k in enumerate(kb))}
    kb_gap = float(np.abs(kb_res["graphed"]["t_wc"]
                          - kb_res["eager"]["t_wc"]).max())
    kb_frames = kb_res["graphed"]["keyframes"]
    kb_dt = kb_res["graphed"]["max_dt_m"]
    print(f"# streams: a batch of {B} from frames {kb} over {STREAM_EVERY} "
          f"frames: keyframes graphed {kb_frames}, eager "
          f"{kb_res['eager']['keyframes']} (single runs {kb_want}); graphed "
          f"against the eager batched step max |dt_wc| {kb_gap:.3e} m (tol "
          f"{STREAM_GRAPH_TOL_M}); against the single runs {kb_dt:.3e} / "
          f"{kb_res['eager']['max_dt_m']:.3e} m", flush=True)
    assert kb_frames == kb_want == kb_res["eager"]["keyframes"] \
        and any(kb_frames.values()), (kb_frames, kb_want)
    assert kb_gap <= STREAM_GRAPH_TOL_M, kb_gap
    assert max(kb_dt, kb_res["eager"]["max_dt_m"]) <= CPU_TOL_M, kb_res

    # --- ops that take vmap's per-stream fallback (a loop over streams),
    # in the eager batched step (a replay dispatches no op) ---------------
    flag = torch._C._functorch._set_vmap_fallback_warning_enabled
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        flag(True)
        try:
            streams._vmapped_step(st, frames(B, STREAM_FRAMES), cam, cfg, ncx,
                                  ncy, shape)
        finally:
            flag(False)
    fallbacks = sorted({str(w.message).split("batching rule for ")[1]
                        .split(".")[0] for w in caught
                        if "batching rule for" in str(w.message)})
    print(f"# streams: ops taking vmap's per-stream fallback: {fallbacks}",
          flush=True)
    assert not fallbacks, fallbacks

    # --- host ms per step at each B and for one stream (graphed vo_step) --
    # STREAM_ROUNDS rounds; each times STREAM_TIMED replays of every config
    # in an order rotated by one per round, so the host clock's drift falls
    # on every B alike; a config's figure is the median of its rounds.  The
    # eager batched step at the largest B is timed once, after round 0.
    configs = ("one",) + tuple(STREAM_BS)
    eager_b = max(STREAM_BS)
    runs, slot_of = {}, {}
    for c in configs + ("eager",):
        st, j = snaps[0] if c == "one" else start(
            eager_b if c == "eager" else c), 0
        for _ in range(STREAM_WARM):
            st, j = advance(st, c, j), j + 1
        runs[c] = [st, j]
        if c != "eager":
            slot_of[c] = graphed.slots()[-1]
    rounds = {c: [] for c in configs + ("eager",)}

    def timed(c):
        st, j = runs[c]
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        for _ in range(STREAM_TIMED):
            st, j = advance(st, c, j), j + 1
        torch.cuda.synchronize()
        rounds[c].append((time.perf_counter() - t0) / STREAM_TIMED * 1e3)
        runs[c] = [st, j]
        return _read_counts()
    for r in range(STREAM_ROUNDS):
        for c in configs[r % len(configs):] + configs[:r % len(configs)]:
            counts = timed(c)
            assert counts == {"tile_gather": 0, "sparse_align": 0}, \
                (c, "a replay dispatched a kernel", counts)
        if r == 0:
            eager_launches = timed("eager")
            assert eager_launches == {
                "tile_gather": K1_PER_FRAME * STREAM_TIMED,
                "sparse_align": STREAM_TIMED}, eager_launches
    med = {c: float(np.median(v)) for c, v in rounds.items()}
    single_ms = med["one"]
    print(f"# one stream, graphed vo_step: {single_ms:.2f} host ms per step "
          f"(median of rounds {[round(x, 2) for x in rounds['one']]}); "
          f"eager batched step at B={eager_b}: {med['eager']:.1f} host ms, "
          f"{eager_b * 1e3 / med['eager']:.2f} stream-frames/s (one round "
          f"of {STREAM_TIMED}, launches {eager_launches})", flush=True)
    by_b = {}
    for Bt in STREAM_BS:
        sb, j = runs[Bt]
        (_, _), syncs = _host_syncs(torch, lambda: step(sb, Bt, j))
        (_, ev), want = _counted(lambda: _raw_profile(
            torch, lambda: step(sb, Bt, j)))
        prof_counts = {k: ev[k] for k in ("tile_gather", "sparse_align")}
        _, slot_mb, capture_s, pool_mb = slot_of[Bt]
        by_b[Bt] = {"host_ms_per_step": med[Bt],
                    "host_ms_rounds": rounds[Bt],
                    "stream_frames_per_s": Bt * 1e3 / med[Bt],
                    "steps": STREAM_TIMED * STREAM_ROUNDS,
                    "profiled_launches_per_step": prof_counts,
                    "device_ops_per_step": ev["device_ops"],
                    "device_ms_per_step": ev["device_ms"],
                    "host_aten_ops_per_step": ev["host_aten_ops"],
                    "host_syncs_per_step": len(syncs),
                    "slot_mb": slot_mb, "capture_s": capture_s,
                    "pool_mb": pool_mb}
        print(f"# streams B={Bt}, graphed: {med[Bt]:.2f} host ms per batched "
              f"step (median of rounds {[round(x, 2) for x in rounds[Bt]]}), "
              f"{by_b[Bt]['stream_frames_per_s']:.2f} stream-frames/s; "
              f"{ev['device_ops']} device ops, {ev['device_ms']:.3f} ms "
              f"device time, {ev['host_aten_ops']} host aten ops per step; "
              f"kernel events per step {prof_counts}; {len(syncs)} host "
              f"syncs; slot {slot_mb:.1f} MB, capture {capture_s:.2f} s, "
              f"pool {pool_mb:.1f} MB"
              + "".join(f"\n#   {x}" for x in syncs), flush=True)
        assert prof_counts == want and want["sparse_align"] == 1 \
            and 1 <= want["tile_gather"] <= K1_PER_FRAME, \
            (Bt, prof_counts, want)
        assert not syncs, f"streams B={Bt}: the batched step waits on the card"
        assert ev["host_aten_ops"] < GRAPH_MAX_CALL_OPS, (Bt, ev)

    seconds = time.perf_counter() - t_phase
    return {"B": B, "frames": STREAM_FRAMES, "max_dt_m": dt,
            "keyframes": kf_frames, "launches": launches,
            "replay_events": replay_events, "by_b": by_b,
            "slot": {"slot_mb": slot_b[1], "capture_s": slot_b[2],
                     "pool_mb": slot_b[3]},
            "vmap_fallbacks": fallbacks,
            "keyframe_batch": {"from_frames": kb, "keyframes": kb_frames,
                               "max_dt_m": kb_dt, "graphed_vs_eager_m":
                               kb_gap, "eager_max_dt_m":
                               kb_res["eager"]["max_dt_m"]},
            "single_stream_host_ms": single_ms,
            "single_stream_host_ms_rounds": rounds["one"],
            "eager": {"B": eager_b, "host_ms_per_step": med["eager"],
                      "stream_frames_per_s": eager_b * 1e3 / med["eager"],
                      "launches": eager_launches, "steps": STREAM_TIMED},
            "k1_batched": {"B": B, "shape": f"17x17x{n}",
                           "device_us": k1_us, "max_abs_err": 0.0},
            "k2_batched": {"B": B, "n_features": int(feats[0].shape[1]),
                           "device_us": k2_us, "device_us_one_stream":
                           k2_us_1, "max_abs_err": k2_err},
            "seconds": seconds}


def _clone_state(state):
    """A copy of a VOState that a donated step may consume."""
    import torch
    import torch.utils._pytree as pytree
    return pytree.tree_map(torch.clone, state)


def _copy_state(dst, src):
    """src's values into dst's storage: a donated step of dst then replays
    the CUDA graph of dst's storage."""
    import torch.utils._pytree as pytree
    pytree.tree_map(lambda d, s_: d.copy_(s_), dst, src)
    return dst


def _cat_outs(*outs):
    """Stacked StepOuts of consecutive scans, one after another along T."""
    import torch
    from rpg_svo_tpu_torch.core.fused import StepOut
    return StepOut(*[torch.cat(x) for x in zip(*outs)])


def _frames_where(flags) -> list:
    """The frames (1-based along T) where a stacked flag is set."""
    return [int(i) + 1 for i in np.flatnonzero(flags.cpu().numpy())]


def _state_ptrs(state) -> list:
    import torch.utils._pytree as pytree
    return [x.data_ptr() for x in pytree.tree_leaves(state)]


def _step_figures(torch, step) -> dict:
    """Host ms of DONATED_TIMED calls (each ending in a synchronize) and
    the most device memory any of them held above what was allocated
    before it, of the call ``step()`` returns (``step`` makes that call's
    input, a clone for a donated step, outside what is timed)."""
    times, peak = [], 0.0
    for _ in range(DONATED_TIMED):
        fn = step()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, (torch.cuda.max_memory_allocated() - base) / 1e6)
    return {"host_ms_calls": times, "peak_mb_above_input": peak}


def _donated_phase(starts, imgs, cam, cfgs, grid, shape) -> dict:
    """Phase 23: the donated step (``vo_step_donated``, a CUDA graph on the
    card: the first call for a state's storage runs the step and captures
    it, later calls replay it) in both presets from a clone of phase 5's
    state before its first keyframe, through the keyframe and
    DONATED_PAST frames past it, against phase 5's run, launches counted
    by the profiler's kernel events; then ``vo_scan_donated`` over the same
    window from another clone; then the keyframe step and the next, each
    by the eager step body (``_eager_step``) and by a replay of
    ``vo_step_donated`` (host ms,
    peak memory, and device ops and device ms of DONATED_PROFILES profiles
    each way, in turns; a device-ms difference counts as resolved only
    where the two ways' profiles do not overlap)."""
    import torch
    from rpg_svo_tpu_torch.core import fused
    ncx, ncy = grid
    t_phase = time.perf_counter()
    res = {}
    for preset, (s, snap, outs, k) in starts.items():
        cfg = cfgs[preset]
        frames = range(s + 1, k + DONATED_PAST + 1)
        st = _clone_state(snap)
        ptrs = _state_ptrs(st)

        def window():
            d_outs, syncs, same = [], [], True
            for j in frames:
                (_, out), sy = _host_syncs(torch, functools.partial(
                    fused.vo_step_donated, st, imgs[j - 1], cam, cfg, ncx,
                    ncy, shape))
                syncs.append(len(sy))
                same &= _state_ptrs(st) == ptrs
                d_outs.append(out)
            return d_outs, syncs, same
        ((d_outs, syncs, same_storage), ev), counted = _counted(
            lambda: _raw_profile(torch, window))
        pos = torch.stack([o.t_wc for o in d_outs]).cpu().numpy()
        ref = np.stack([outs[j - 1].t_wc.cpu().numpy() for j in frames])
        dt = float(np.abs(pos - ref).max())
        kfs = [j for j, o in zip(frames, d_outs) if bool(o.is_keyframe)]
        kfs_ref = [j for j in frames if bool(outs[j - 1].is_keyframe)]
        _, s_outs = fused.vo_scan_donated(
            _clone_state(snap), imgs[s:frames[-1]], cam, cfg, ncx, ncy, shape)
        scan_dt = float(torch.abs(
            s_outs.t_wc - torch.stack([o.t_wc for o in d_outs])).max())
        scan_kfs = [j for j, f in zip(frames, s_outs.is_keyframe.tolist())
                    if f]
        launches = {key: ev[key] for key in ("tile_gather", "sparse_align")}
        want = counted
        print(f"# donated {preset}: frames {s + 1}-{frames[-1]} from a clone "
              f"of the state after frame {s} (the first a capture, then "
              f"replays): max |dt_wc| against phase 5 {dt:.3e} m (tol "
              f"{DONATED_TOL_M}); keyframes {kfs} (phase 5: {kfs_ref}); "
              f"kernel events {launches} (want {want}); host syncs per frame "
              f"{syncs}; every leaf's data pointer unchanged: {same_storage}; "
              f"vo_scan_donated against the step loop: max |dt_wc| "
              f"{scan_dt:.3e} m, keyframes {scan_kfs}", flush=True)
        assert np.isfinite(pos).all() and dt <= DONATED_TOL_M, (preset, dt)
        assert kfs == kfs_ref and kfs and kfs[0] == k, (preset, kfs, kfs_ref)
        assert launches == want and want["sparse_align"] == len(frames) \
            and want["tile_gather"] <= K1_PER_FRAME * len(frames), \
            (preset, launches, want)
        assert not any(syncs), (preset, syncs)
        assert same_storage, f"{preset}: a donated leaf moved"
        assert scan_dt <= DONATED_TOL_M and scan_kfs == kfs, (preset, scan_dt)

        # the keyframe step and the next, each way, interleaved; the
        # donated calls step one state buffer, so each replays its graph
        st = snap
        for j in range(s + 1, k):
            st, _ = _eager_step(st, imgs[j - 1], cam, cfg, ncx, ncy, shape)
        buf = _clone_state(st)
        fused.vo_step_donated(buf, imgs[k - 1], cam, cfg, ncx, ncy, shape)
        steps = {}
        for label, j in (("keyframe", k), ("other", k + 1)):
            def plain(st=st, j=j):
                return functools.partial(_eager_step, st, imgs[j - 1], cam,
                                         cfg, ncx, ncy, shape)

            def donated(st=st, j=j):
                return functools.partial(fused.vo_step_donated,
                                         _copy_state(buf, st), imgs[j - 1],
                                         cam, cfg, ncx, ncy, shape)
            ways = {"eager": plain, "vo_step_donated": donated}
            # in turns: plain, donated, donated, plain
            runs = [(way, _step_figures(torch, ways[way])) for way in
                    ("eager", "vo_step_donated", "vo_step_donated",
                     "eager")]
            profs = {way: [] for way in ways}
            for r in range(DONATED_PROFILES):
                for way in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
                    profs[way].append(_device_totals(torch, ways[way]()))
            fig = {}
            for way in ways:
                mine = [x for w, x in runs if w == way]
                calls = [t for x in mine for t in x["host_ms_calls"]]
                ms = [p[1] for p in profs[way]]
                fig[way] = {
                    "host_ms": statistics.median(calls),
                    "host_ms_calls": calls,
                    "peak_mb_above_input": max(
                        x["peak_mb_above_input"] for x in mine),
                    "device_ops": [p[0] for p in profs[way]],
                    "device_ms": statistics.median(ms),
                    "device_ms_profiles": ms}
            f, d = fig["eager"], fig["vo_step_donated"]
            fm, dm = f["device_ms_profiles"], d["device_ms_profiles"]
            resolved = max(dm) < min(fm) or max(fm) < min(dm)
            steps[label] = dict(fig, frame=j, device_ms_resolved=resolved)
            print(f"# donated {preset} {label} step (frame {j}), eager "
                  f"vo_step body / vo_step_donated (a replay): host "
                  f"{f['host_ms']:.2f} / "
                  f"{d['host_ms']:.2f} ms (median of {len(f['host_ms_calls'])}"
                  f" calls each), device ops {f['device_ops']} / "
                  f"{d['device_ops']}, device {f['device_ms']:.3f} "
                  f"[{min(fm):.3f}-{max(fm):.3f}] / {d['device_ms']:.3f} "
                  f"[{min(dm):.3f}-{max(dm):.3f}] ms (median [range] of "
                  f"{DONATED_PROFILES} profiles each, in turns; difference "
                  f"{d['device_ms'] - f['device_ms']:+.3f} ms, "
                  f"{'resolved' if resolved else 'unresolved: the ranges overlap'}"
                  f"), peak memory above the input "
                  f"{f['peak_mb_above_input']:.1f} / "
                  f"{d['peak_mb_above_input']:.1f} MB", flush=True)
            st = _eager_step(st, imgs[j - 1], cam, cfg, ncx, ncy, shape)[0]
        del buf
        res[preset] = {"frames": [s + 1, frames[-1]], "max_dt_m": dt,
                       "keyframes": kfs, "launches": launches,
                       "n_frames": len(frames), "host_syncs": syncs,
                       "leaves_kept_storage": same_storage,
                       "scan_max_dt_m": scan_dt, "steps": steps}
    res["seconds"] = time.perf_counter() - t_phase
    return res


def _stage_phase(snap, imgs, cam, cfg, grid, shape) -> dict:
    """Phase 24: the eight code-level stubs of tools_stage_timing.py
    (``cfg.ablate``), fast, each through ``vo_step_donated`` on a state
    buffer of its own (one CUDA graph per variant, captured by its first
    warm-up step; the timed steps are replays), the buffer set to the
    state after frame STAGE_FROM before each round: STAGE_ROUNDS
    interleaved rounds of STAGE_WARM warm-up and STAGE_TIMED timed steps;
    host ms per step, failed and keyframe counts of the timed steps;
    device ops, device ms and the K1 and K2 kernel events of one more
    step."""
    import torch
    from rpg_svo_tpu_torch.core import fused
    ncx, ncy = grid
    t_phase = time.perf_counter()
    names = tuple(STAGE_VARIANTS)
    rounds = {v: [] for v in names}
    counted = {v: {"failed": 0, "keyframes": 0} for v in names}
    bufs, prof = {}, {}
    for r in range(STAGE_ROUNDS):
        for v in names[r % len(names):] + names[:r % len(names)]:
            c = cfg.replace(ablate=STAGE_VARIANTS[v])
            if v in bufs:
                st = _copy_state(bufs[v], snap)
            else:
                st = bufs[v] = _clone_state(snap)
            j = STAGE_FROM
            for _ in range(STAGE_WARM):
                fused.vo_step_donated(st, imgs[j], cam, c, ncx, ncy, shape)
                j += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = []
            for _ in range(STAGE_TIMED):
                outs.append(fused.vo_step_donated(st, imgs[j], cam, c, ncx,
                                                  ncy, shape)[1])
                j += 1
            torch.cuda.synchronize()
            rounds[v].append((time.perf_counter() - t0) / STAGE_TIMED * 1e3)
            pos = torch.stack([o.t_wc for o in outs]).cpu().numpy()
            assert np.isfinite(pos).all(), (v, "a pose is not finite")
            counted[v]["failed"] += sum(bool(o.failed) for o in outs)
            counted[v]["keyframes"] += sum(bool(o.is_keyframe) for o in outs)
            if v not in prof:
                ops, dms, kms, p_ = _device_profile(
                    torch, functools.partial(fused.vo_step_donated, st,
                                             imgs[j], cam, c, ncx, ncy,
                                             shape))
                prof[v] = (ops, dms, kms, _kernel_counts(p_))
    bufs.clear()
    n_steps = STAGE_ROUNDS * STAGE_TIMED
    table = {}
    for v in names:
        ops, dms, kms, kcount = prof[v]
        table[v] = {"ablate": list(STAGE_VARIANTS[v]),
                    "host_ms": float(np.median(rounds[v])),
                    "host_ms_rounds": rounds[v], "device_ops": ops,
                    "device_ms": dms, "kernel_device_ms": kms,
                    "launches_per_step": kcount,
                    "failed": counted[v]["failed"],
                    "keyframes": counted[v]["keyframes"], "steps": n_steps}
    full = table["full"]
    for v in names:
        t = table[v]
        t["minus_full"] = {k: t[k] - full[k] for k in
                           ("host_ms", "device_ops", "device_ms")}
        print(f"# stages {v:13s} host {t['host_ms']:7.2f} ms "
              f"({', '.join(f'{x:.1f}' for x in t['host_ms_rounds'])}) "
              f"[{t['minus_full']['host_ms']:+.2f}], device "
              f"{t['device_ms']:.3f} ms [{t['minus_full']['device_ms']:+.3f}]"
              f", {t['device_ops']} ops [{t['minus_full']['device_ops']:+d}]"
              f"; K1, K2 kernel events per step "
              f"{t['launches_per_step']['tile_gather']}, "
              f"{t['launches_per_step']['sparse_align']}; failed "
              f"{t['failed']}, keyframes {t['keyframes']} of {n_steps}",
              flush=True)
        if "align" in STAGE_VARIANTS[v]:
            assert t["launches_per_step"]["sparse_align"] == 0, (v, t)
    return {"from_frame": STAGE_FROM, "rounds": STAGE_ROUNDS,
            "warm": STAGE_WARM, "timed": STAGE_TIMED, "variants": table,
            "seconds": time.perf_counter() - t_phase}


def _graph_phase(seeded, imgs, phase5_outs, cam, cfgs, grid, shape,
                 gt) -> dict:
    """Phase 25: the donated step as one CUDA graph.  Per preset, from a
    clone of the seeded state, ``vo_scan_donated`` over frames 1-n
    (PRESET_FRAMES): frame 1 runs the step and captures it, then frames
    2..n-GRAPH_PROFILED under sync debug mode and the last GRAPH_PROFILED
    under the profiler are replays.  Against phase 5's eager step body
    (GRAPH_TOL_M, the same keyframes) and the pins' limits; host syncs,
    K1 and K2 kernel events, host aten ops and device ms per replayed
    frame; capture seconds and the graph's pool.  Then host ms per frame
    over frames 1-GRAPH_TIMED from the seeded state, in GRAPH_ROUNDS
    interleaved rounds, of the eager step body, of the donated step's
    replays and of graphed ``vo_step`` (its slot's copy in, a replay, a
    copy out), and each way's device busy share (device ms per frame over
    host ms per frame) and host aten ops per frame."""
    import torch
    from rpg_svo_tpu_torch.core import fused, graphed
    ncx, ncy = grid
    t_phase = time.perf_counter()
    res = {}
    for preset, cfg in cfgs.items():
        n, P = PRESET_FRAMES[preset], GRAPH_PROFILED
        scan = functools.partial(fused.vo_scan_donated, cam=cam, cfg=cfg,
                                 ncx=ncx, ncy=ncy, img_shape=shape)
        st = _clone_state(seeded[preset])
        t0 = time.perf_counter()
        st, outs = scan(st, imgs[:1])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        _, key_capture_s, key_pool_mb = graphed.graphs()[-1]
        (st, outs2), syncs = _host_syncs(torch, lambda: scan(st, imgs[1:n - P]))
        ((st, outs3), ev), counted = _counted(lambda: _raw_profile(
            torch, lambda: scan(st, imgs[n - P:n])))
        outs = _cat_outs(outs, outs2, outs3)
        pos = outs.t_wc.cpu().numpy()
        ref = np.stack([o.t_wc.cpu().numpy() for o in phase5_outs[preset][:n]])
        dt = float(np.abs(pos - ref).max())
        kfs = _frames_where(outs.is_keyframe)
        kfs_ref = [i for i, o in enumerate(phase5_outs[preset][:n], 1)
                   if bool(o.is_keyframe)]
        failed = _frames_where(outs.failed)
        terr = np.linalg.norm(pos - gt[:n], axis=-1)[TIMED_FROM - 1:]
        med, mx = float(np.median(terr)) * 1e3, float(terr.max()) * 1e3
        per = {k_: ev[k_] / P for k_ in ("tile_gather", "sparse_align",
                                         "host_aten_ops", "device_ops",
                                         "device_ms")}
        # frames 1-GRAPH_TIMED from the seeded state: the eager body, the
        # donated step's replays (the scan's state set to the seeded one:
        # the scan's graph) and graphed vo_step (a copy into its slot, a
        # replay, a copy out; its slot made and captured before the rounds)
        steps = {"eager": _eager_step, "graphed": fused.vo_step_donated,
                 "vo_step": fused.vo_step}

        def block(way):
            src = seeded[preset]
            if way == "graphed":
                src = _copy_state(st, src)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(GRAPH_TIMED):
                src, _ = steps[way](src, imgs[i], cam, cfg, ncx, ncy, shape)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / GRAPH_TIMED * 1e3
        fused.vo_step(seeded[preset], imgs[0], cam, cfg, ncx, ncy, shape)
        ways = tuple(steps)
        rounds = {w: [] for w in ways}
        for r in range(GRAPH_ROUNDS):
            for way in ways[r % len(ways):] + ways[:r % len(ways)]:
                rounds[way].append(block(way))
        host = {w: statistics.median(v) for w, v in rounds.items()}
        # device ms and host aten ops per frame of the same frames, each
        # way profiled once more: the busy share is device ms over the
        # median host ms
        blocks = {w: {k_: v / GRAPH_TIMED for k_, v in
                      _raw_profile(torch, functools.partial(block, w))[1]
                      .items()} for w in rounds}
        busy = {w: blocks[w]["device_ms"] / host[w] for w in rounds}
        res[preset] = {
            "frames": n, "max_dt_m": dt, "keyframes": kfs,
            "median_terr_mm": med, "max_terr_mm": mx,
            "first_call_s": first_s, "capture_s": key_capture_s,
            "pool_mb": key_pool_mb,
            "host_syncs_replayed": len(syncs), "replayed_syncs_at": syncs,
            "per_replayed_frame": per, "profiled_frames": P,
            "per_frame_timed": blocks, "host_ms_per_frame": host,
            "host_ms_rounds": rounds, "device_busy_share": busy,
            "launches": {k_: ev[k_] for k_ in ("tile_gather",
                                               "sparse_align")}}
        print(f"# graphed {preset}: vo_scan_donated over frames 1-{n} (frame "
              f"1 {first_s:.2f} s: its step and a capture of "
              f"{key_capture_s:.2f} s, pool {key_pool_mb:.1f} MB; then "
              f"replays): max |dt_wc| against phase 5's vo_step {dt:.3e} m "
              f"(tol {GRAPH_TOL_M[preset]}); keyframes {kfs} (phase 5: "
              f"{kfs_ref}); terr over frames {TIMED_FROM}-{n} median "
              f"{med:.3f} mm, max {mx:.3f} mm; {len(syncs)} host syncs over "
              f"frames 2-{n - P}; per replayed frame (frames {n - P + 1}-{n},"
              f" profiler): K1 {per['tile_gather']}, K2 "
              f"{per['sparse_align']}, host aten ops {per['host_aten_ops']} "
              f"(eager body, frames 1-{GRAPH_TIMED}: "
              f"{blocks['eager']['host_aten_ops']:.0f}), device ops "
              f"{per['device_ops']}, device {per['device_ms']:.3f} ms" + "".join(
                  f"\n#   {x}" for x in syncs), flush=True)
        print(f"# graphed {preset}: host ms per frame over frames "
              f"1-{GRAPH_TIMED}, median of {GRAPH_ROUNDS} interleaved rounds "
              f"(rounds); device ms per frame (profiled); device busy share; "
              f"host aten ops per frame: " + "; ".join(
                  f"{w} {host[w]:.2f} (" + ", ".join(
                      f"{x:.2f}" for x in rounds[w]) + f"), "
                  f"{blocks[w]['device_ms']:.3f} ms, {busy[w]:.3f}, "
                  f"{blocks[w]['host_aten_ops']:.1f}" for w in ways),
              flush=True)
        assert np.isfinite(pos).all() and not failed, (preset, failed)
        assert dt <= GRAPH_TOL_M[preset], (preset, dt)
        assert kfs == kfs_ref and kfs, (preset, kfs, kfs_ref)
        lim = LIMITS_MM[preset]
        assert med <= lim[0] and mx <= lim[1], (preset, med, mx, lim)
        assert not syncs, (preset, syncs)
        assert ev["tile_gather"] == counted["tile_gather"] \
            <= K1_PER_FRAME * P and ev["sparse_align"] == P \
            == counted["sparse_align"], (preset, ev, counted)
        assert per["host_aten_ops"] < GRAPH_MAX_HOST_OPS, (preset, per)
        del st
    res["seconds"] = time.perf_counter() - t_phase
    return res


def _kept_phase(seeded, imgs, phase5_outs, cam, cfgs, grid, shape,
                gt) -> dict:
    """Phase 26: the entries that keep their input state as CUDA graphs.
    Every graph and slot is dropped first, so each preset's first call
    makes its slot and captures.  Per preset: ``vo_scan`` over frames 1-n
    (PRESET_FRAMES) from the seeded state (its copy into the slot, frame 1
    a capture, the rest replays, one copy out) against phase 5's eager
    body (GRAPH_TOL_M, the same keyframes) and the pins' limits, host
    syncs over the scan, the input equal to a clone of it taken before;
    ``vo_scan`` again from a clone over frames 1-KEPT_AGAIN: no capture,
    the same outputs; the host aten ops and kernel events of a replayed
    frame inside ``vo_scan`` (scans of 2P and of P frames, differenced);
    then one ``vo_step`` call (host syncs, kernel events, host aten ops)
    and its copy in and copy out alone (host aten ops; device us from
    CUDA-graph replays of each)."""
    import torch
    import torch.utils._pytree as pytree
    from rpg_svo_tpu_torch.core import fused, graphed
    ncx, ncy = grid
    t_phase = time.perf_counter()
    graphed.clear()
    res = {}
    for preset, cfg in cfgs.items():
        n, P = PRESET_FRAMES[preset], GRAPH_PROFILED
        scan = functools.partial(fused.vo_scan, cam=cam, cfg=cfg, ncx=ncx,
                                 ncy=ncy, img_shape=shape)
        src = seeded[preset]
        before = _clone_state(src)
        _reset_counts()
        t0 = time.perf_counter()
        (st, outs), syncs = _host_syncs(torch, lambda: scan(src, imgs[:n]))
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        launches = _read_counts()
        _, slot_mb, capture_s, pool_mb = graphed.slots()[-1]
        kept = all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(before), pytree.tree_leaves(src)))
        del before
        pos = outs.t_wc.cpu().numpy()
        ref = np.stack([o.t_wc.cpu().numpy() for o in phase5_outs[preset][:n]])
        dt = float(np.abs(pos - ref).max())
        kfs = _frames_where(outs.is_keyframe)
        kfs_ref = [i for i, o in enumerate(phase5_outs[preset][:n], 1)
                   if bool(o.is_keyframe)]
        failed = _frames_where(outs.failed)
        terr = np.linalg.norm(pos - gt[:n], axis=-1)[TIMED_FROM - 1:]
        med, mx = float(np.median(terr)) * 1e3, float(terr.max()) * 1e3
        counts = (len(graphed.graphs()), len(graphed.slots()))
        _, again = scan(_clone_state(src), imgs[:KEPT_AGAIN])
        no_capture = counts == (len(graphed.graphs()), len(graphed.slots()))
        again_dt = float(torch.abs(again.t_wc - outs.t_wc[:KEPT_AGAIN]).max())
        (_, e1), c1 = _counted(lambda: _raw_profile(
            torch, lambda: scan(st, imgs[n:n + P])))
        (_, e2), c2 = _counted(lambda: _raw_profile(
            torch, lambda: scan(st, imgs[n:n + 2 * P])))
        per = {k_: (e2[k_] - e1[k_]) / P for k_ in e1}
        per_want = {k_: (c2[k_] - c1[k_]) / P for k_ in c1}
        step = functools.partial(fused.vo_step, st, imgs[n], cam, cfg, ncx,
                                 ncy, shape)
        (_, _), step_syncs = _host_syncs(torch, step)
        (_, call), call_want = _counted(lambda: _raw_profile(torch, step))
        # the copies alone: host aten ops from the profiler, device us
        # from CUDA-graph replays of them (the profiler may return no event
        # for so short a run)
        static = fused._static_args(cam, cfg, ncx, ncy, shape)
        copies = {"copy_in": lambda: graphed.slot(static, st, imgs[n]),
                  "copy_out": functools.partial(
                      graphed.fresh_copy, graphed.slot(static, st, imgs[n]))}
        copy = {}
        for k_, fn in copies.items():
            copy[k_] = {"host_aten_ops": _raw_profile(torch, fn)[1][
                "host_aten_ops"], "device_us": _graph_us(torch, fn, reps=3)}
        copy_in, copy_out = copy["copy_in"], copy["copy_out"]
        res[preset] = {
            "frames": n, "max_dt_m": dt, "keyframes": kfs,
            "median_terr_mm": med, "max_terr_mm": mx, "scan_s": scan_s,
            "capture_s": capture_s, "slot_mb": slot_mb, "pool_mb": pool_mb,
            "host_syncs": len(syncs), "syncs_at": syncs,
            "wrapper_launches": launches, "input_kept": kept,
            "second_call_captures": not no_capture,
            "second_call_max_dt_m": again_dt,
            "per_replayed_frame": per, "vo_step_call": call,
            "vo_step_call_syncs": len(step_syncs), "copy_in": copy_in,
            "copy_out": copy_out}
        print(f"# kept {preset}: graphed vo_scan over frames 1-{n} "
              f"({scan_s:.2f} s; slot {slot_mb:.1f} MB, capture "
              f"{capture_s:.2f} s, pool {pool_mb:.1f} MB): max |dt_wc| "
              f"against phase 5's eager body {dt:.3e} m (tol "
              f"{GRAPH_TOL_M[preset]}); keyframes {kfs} (phase 5: "
              f"{kfs_ref}); terr over frames {TIMED_FROM}-{n} median "
              f"{med:.3f} mm, max {mx:.3f} mm; {len(syncs)} host syncs; "
              f"wrapper launches {launches} (the capture call); input "
              f"unchanged: {kept}; a second call from a clone over frames "
              f"1-{KEPT_AGAIN}: new capture {not no_capture}, max |dt_wc| "
              f"{again_dt:.3e} m; per replayed frame inside vo_scan: K1 "
              f"{per['tile_gather']}, K2 {per['sparse_align']}, host aten "
              f"ops {per['host_aten_ops']}, device {per['device_ms']:.3f} ms"
              + "".join(f"\n#   {x}" for x in syncs), flush=True)
        print(f"# kept {preset}: one vo_step call: {len(step_syncs)} host "
              f"syncs, K1 {call['tile_gather']}, K2 {call['sparse_align']}, "
              f"host aten ops {call['host_aten_ops']} (copy in "
              f"{copy_in['host_aten_ops']}, copy out "
              f"{copy_out['host_aten_ops']}), device {call['device_ms']:.3f} "
              f"ms (copy in {copy_in['device_us']:.1f} us, copy out "
              f"{copy_out['device_us']:.1f} us, CUDA-graph replays)",
              flush=True)
        assert np.isfinite(pos).all() and not failed, (preset, failed)
        assert dt <= GRAPH_TOL_M[preset], (preset, dt)
        assert kfs == kfs_ref and kfs, (preset, kfs, kfs_ref)
        lim = LIMITS_MM[preset]
        assert med <= lim[0] and mx <= lim[1], (preset, med, mx, lim)
        assert not syncs and not step_syncs, (preset, syncs, step_syncs)
        assert launches == {"tile_gather": K1_PER_FRAME,
                            "sparse_align": 1}, (preset, launches)
        assert kept, f"{preset}: vo_scan wrote its input state"
        assert no_capture and again_dt == 0.0, (preset, again_dt)
        assert (per["tile_gather"], per["sparse_align"]) \
            == (per_want["tile_gather"], 1) \
            and per_want["tile_gather"] <= K1_PER_FRAME, (preset, per)
        assert (call["tile_gather"], call["sparse_align"]) \
            == (call_want["tile_gather"], 1) \
            and call_want["tile_gather"] <= K1_PER_FRAME, (preset, call)
        assert per["host_aten_ops"] < GRAPH_MAX_HOST_OPS, (preset, per)
        assert call["host_aten_ops"] < GRAPH_MAX_CALL_OPS, (preset, call)
        del st
    res["seconds"] = time.perf_counter() - t_phase
    return res


def _handler_graph_phase(scene, cfgs, cam, imgs, first) -> dict:
    """Phase 27: FrameHandler's jitted stages as CUDA graphs.  Every graph
    is dropped first, so each stage captures on its first call.  Per
    preset: the handler from ground-truth depth over frames 1-HG_FRAMES
    with graphs and again under ``graphed.disable()`` (the eager
    reference): the largest gap between the two tracks (HG_TOL_M), the
    same keyframes and results, captures after the first keyframe (none)
    and evictions (none); then over the HG_WINDOW frames from the snapshot
    before the first keyframe, each way: host ms per frame (the median of
    HG_ROUNDS interleaved rounds, each from the snapshot), device ms,
    device busy share, host aten ops, K1/K2 launches per frame as
    counted (``_run_launches``; equal both ways) and the profiler's kernel
    events (one profiled replay of the window, its misses reported), host
    syncs per frame (sync debug mode plus the stage timers'), and with
    graphs the MB copied in and out per frame and the copies' device ms;
    per wrapped
    function its graphs, captures, replays, input-buffer MB (the buffers
    are shared between stages), pool MB and capture seconds."""
    import torch
    from rpg_svo_tpu_torch.core import graphed
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    t_phase = time.perf_counter()
    graphed.clear()
    res = {}
    ways = ("graphed", "eager")

    def mode(way):
        return graphed.disable() if way == "eager" \
            else contextlib.nullcontext()
    for preset in ("fast", "accurate"):
        cfg = cfgs[preset]
        runs = {}
        for way in ways:
            if way == "graphed":
                graphed.clear()         # each stage captures in this run
            graphed.reset_jit_counts()
            with mode(way):
                fh = FrameHandler(cam, cfg, scene.shape, device=scene.dev)
                fh.set_first_frame_with_depth(first[0], scene.T0.inverse(),
                                              first[1])
                snaps = {0: _snapshot(fh)}
                infos, pos, caps = [], [], []
                t0 = time.perf_counter()
                for i in range(1, HG_FRAMES + 1):
                    infos.append(fh.add_image(imgs[i - 1], i / 50.0))
                    pos.append(fh.last_frame.T_f_w.inverse().t)
                    caps.append(sum(v["captures"] for v in
                                    graphed.jit_stats().values()))
                    if i % SNAP_EVERY == 0:
                        snaps[i] = _snapshot(fh)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            runs[way] = {
                "infos": infos, "snaps": snaps, "caps": caps,
                "stats": graphed.jit_stats(),
                "pos": torch.stack(pos).cpu().numpy(),
                "ms_per_frame": wall / HG_FRAMES * 1e3,
                "kfs": [i for i, f in enumerate(infos, 1)
                        if f.get("is_keyframe")],
                "evictions": sum(v["evictions"] for v in
                                 graphed.jit_stats().values())}
        g, e = runs["graphed"], runs["eager"]
        k0 = g["kfs"][0] if g["kfs"] else HG_FRAMES
        gap = float(np.abs(g["pos"] - e["pos"]).max())
        caps_after = g["caps"][-1] - g["caps"][k0 - 1]
        same_results = [f["result"] for f in g["infos"]] \
            == [f["result"] for f in e["infos"]]
        # the window: HG_WINDOW frames from the snapshot before k0
        s = max(i for i in g["snaps"] if i < k0)
        window = range(s + 1, s + HG_WINDOW + 1)

        def run_window(way):
            h = _snapshot(runs[way]["snaps"][s])
            with mode(way):
                return [h.add_image(imgs[j - 1], j / 50.0) for j in window]
        rounds = {w: [] for w in ways}
        for r in range(HG_ROUNDS):
            for way in (ways if r % 2 == 0 else ways[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_window(way)
                torch.cuda.synchronize()
                rounds[way].append((time.perf_counter() - t0)
                                   / HG_WINDOW * 1e3)
        per = {}
        for way in ways:
            # one profiled replay of the window, its launches counted
            _reset_counts()
            _, ev = _raw_profile(torch, lambda: run_window(way))
            counted = _run_launches()
            misses = _seen_by_profiler(ev, counted, (preset, way))
            mb1 = graphed.jit_stats()
            _, syncs = _host_syncs(torch, lambda: run_window(way))
            host = statistics.median(rounds[way])
            per[way] = {
                "host_ms_per_frame": host, "rounds_ms": rounds[way],
                "device_ms_per_frame": ev["device_ms"] / HG_WINDOW,
                "device_ops_per_frame": ev["device_ops"] / HG_WINDOW,
                "busy_share": ev["device_ms"] / HG_WINDOW / host,
                "host_aten_ops_per_frame": ev["host_aten_ops"] / HG_WINDOW,
                "tile_gather": counted["tile_gather"],
                "sparse_align": counted["sparse_align"],
                "events": {k: ev[k] for k in counted},
                "profiler_misses": misses,
                "events_per_frame": {k: ev[k] / HG_WINDOW for k in counted},
                "launches_per_frame": {k: v / HG_WINDOW
                                       for k, v in counted.items()},
                "host_syncs_per_frame": len(syncs) / HG_WINDOW,
                "sync_sites": sorted(set(syncs)),
                "copy_device_ms_per_frame": ev["foreach_copy_ms"]
                / HG_WINDOW,
                "mb_in_per_frame": sum(
                    v["in_copied_mb"] for v in mb1.values()) / HG_WINDOW,
                "mb_out_per_frame": sum(
                    v["out_copied_mb"] for v in mb1.values()) / HG_WINDOW}
        stats = {k.rsplit(".", 1)[-1]: {
            f: v[f] for f in ("graphs", "captures", "replays", "in_mb",
                              "pool_mb", "capture_s")}
            for k, v in g["stats"].items() if v["graphs"]}
        res[preset] = {
            "frames": HG_FRAMES, "gap_m": gap, "keyframes": g["kfs"],
            "keyframes_eager": e["kfs"], "same_results": same_results,
            "captures": g["caps"][-1], "captures_to_first_keyframe":
            g["caps"][k0 - 1], "captures_after_first_keyframe": caps_after,
            "evictions": g["evictions"],
            "ms_per_frame_run": {w: runs[w]["ms_per_frame"] for w in ways},
            "window": [s + 1, s + HG_WINDOW], "by_way": per,
            "functions": stats, "buffer_mb": graphed.buffer_mb(),
            "device_memory_mb": torch.cuda.memory_reserved() / 1e6,
            "pool_mb": sum(v["pool_mb"] for v in stats.values())}
        gp, ep = per["graphed"], per["eager"]
        print(f"# FrameHandler {preset} graphed against eager over frames "
              f"1-{HG_FRAMES}: gap {gap:.3e} m (tol {HG_TOL_M[preset]}), "
              f"keyframes {g['kfs']} / {e['kfs']}; captures {g['caps'][-1]} "
              f"({caps_after} after frame {k0}), evictions "
              f"{g['evictions']}; whole run {g['ms_per_frame']:.2f} / "
              f"{e['ms_per_frame']:.2f} ms/frame; frames {s + 1}-"
              f"{s + HG_WINDOW}, graphed / eager: host ms per frame "
              f"{gp['host_ms_per_frame']:.2f} ({min(gp['rounds_ms']):.2f}-"
              f"{max(gp['rounds_ms']):.2f}) / {ep['host_ms_per_frame']:.2f} "
              f"({min(ep['rounds_ms']):.2f}-{max(ep['rounds_ms']):.2f}), "
              f"device {gp['device_ms_per_frame']:.3f} / "
              f"{ep['device_ms_per_frame']:.3f} ms, busy "
              f"{gp['busy_share']:.3f} / {ep['busy_share']:.3f}, host aten "
              f"ops {gp['host_aten_ops_per_frame']:.1f} / "
              f"{ep['host_aten_ops_per_frame']:.1f}, host syncs "
              f"{gp['host_syncs_per_frame']:.2f} / "
              f"{ep['host_syncs_per_frame']:.2f}, K1/K2 launches per frame "
              f"{gp['launches_per_frame']} / {ep['launches_per_frame']} "
              f"(kernel events {gp['events']} / {ep['events']}); copies "
              f"{gp['mb_in_per_frame']:.1f} MB in and "
              f"{gp['mb_out_per_frame']:.1f} MB out per frame, "
              f"{gp['copy_device_ms_per_frame'] * 1e3:.1f} us on the card; "
              f"input buffers {res[preset]['buffer_mb']:.1f} MB, pools "
              f"{res[preset]['pool_mb']:.1f} MB; per function "
              + json.dumps({k: [v["graphs"], round(v["in_mb"], 1),
                                round(v["pool_mb"], 1)]
                            for k, v in stats.items()}), flush=True)
        assert not [f for f in g["infos"] if f["result"] == "failure"]
        assert gap <= HG_TOL_M[preset], (preset, gap)
        assert g["kfs"] == e["kfs"] and g["kfs"] and same_results, \
            (preset, g["kfs"], e["kfs"])
        assert caps_after == 0 and g["evictions"] == 0, res[preset]
        assert (gp["tile_gather"], gp["sparse_align"]) \
            == (ep["tile_gather"], ep["sparse_align"]), (gp, ep)
        assert gp["tile_gather"] > 0 and gp["sparse_align"] > 0, gp
        assert gp["host_syncs_per_frame"] <= ep["host_syncs_per_frame"], \
            (gp["sync_sites"], ep["sync_sites"])
    res["seconds"] = time.perf_counter() - t_phase
    return res


def _mesh_world() -> int:
    """Phase 22, run in its own process: a process group of one rank on
    the card (NCCL) and each mesh program against its single-device
    counterpart; prints one JSON line."""
    import torch
    from rpg_svo_tpu_torch.ba.schur import BAProblem, solve_ba
    from rpg_svo_tpu_torch.config import bench_cfg
    from rpg_svo_tpu_torch.core import fused, graphed
    from rpg_svo_tpu_torch.core.depth_filter import seed_variance_update
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    from rpg_svo_tpu_torch.ops.detector import grid_dims
    from rpg_svo_tpu_torch.parallel import gspmd, multihost, sharded, streams
    from rpg_svo_tpu_torch.parallel.ba import distributed_ba_solve
    from rpg_svo_tpu_torch.parallel.fused_mesh import vo_step_mesh
    from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset
    import socket
    import torch.distributed as dist

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    t0 = time.perf_counter()
    dev = multihost.init_multihost(f"127.0.0.1:{port}", 1, 0)
    mesh = sharded.make_mesh()
    res = {"device": str(dev), "backend": dist.get_backend(),
           "mesh": list(mesh.mesh.shape), "world_size":
               dist.get_world_size()}
    rng = np.random.default_rng(22)
    T = lambda a: torch.as_tensor(np.asarray(a)).to(dev)  # noqa: E731

    def gap(a, b):
        return float(torch.abs(a.float() - b.float()).max())

    def counted(fn):
        with gspmd.record_collectives() as log:
            out = fn()
        return out, log

    # pose: the sharded loop against the same steps on one device
    p_w = T((rng.uniform(-1, 1, (128, 3)) + [0, 0, 3]).astype(np.float32))
    T_gt = SE3.exp(T(np.float32([0.2, -0.1, 0.05, 0.03, 0.02, -0.01])))
    f = T_gt.apply(p_w)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    level = T(rng.integers(0, 3, 128).astype(np.int32))
    valid = T(rng.uniform(size=128) < 0.95)
    T0 = SE3.identity(device=dev)
    Tm, coll = counted(lambda: sharded.sharded_pose_optimize(
        mesh, T0, *sharded.shard_on(mesh, (p_w, f, level, valid)),
        n_iter=10))
    Ts = T0
    sic = 1.0 / torch.exp2(level.float())
    for _ in range(10):
        Ts, _ = sharded.distributed_pose_gn_step(Ts, p_w, f, sic, valid, 1.0,
                                                 axis="")
    res["pose"] = {"gap": max(gap(Tm.R, Ts.R), gap(Tm.t, Ts.t)),
                   "terr_m": float(torch.linalg.vector_norm(Tm.t - T_gt.t)),
                   "collectives": len(coll)}

    # seeds: the sharded update against the plain update and masks
    S = 256
    mu = T(rng.uniform(0.3, 0.8, S).astype(np.float32))
    args = (mu, T(np.where(rng.uniform(size=S) < 0.3, 2e-5, 0.05)
                  .astype(np.float32)), T(np.full(S, 10.0, np.float32)),
            T(np.full(S, 10.0, np.float32)), T(np.full(S, 2.0, np.float32)),
            mu + T(rng.normal(0, 0.01, S).astype(np.float32)),
            T(np.full(S, 1e-3, np.float32)), T(rng.uniform(size=S) < 0.9))
    out, coll = counted(lambda: sharded.sharded_seed_update(
        mesh, *sharded.shard_on(mesh, args)))
    m2, s2, a2, b2 = seed_variance_update(*args[:7])
    act = args[7]
    want = [torch.where(act, x, y) for x, y in zip((m2, s2, a2, b2),
                                                   args[:4])]
    conv = act & (torch.sqrt(torch.clamp(want[1], min=0.0)) < args[4] / 200)
    res["seeds"] = {"gap": max(gap(a, b) for a, b in zip(out[:4], want)),
                    "n_conv": int(out[4]), "n_conv_single": int(conv.sum()),
                    "collectives": len(coll)}

    # BA: the sharded solve against the same solve without an axis, and
    # against the single-device solve_ba
    K, P, M = 4, 256, 4
    p_gt = (rng.uniform(-1, 1, (P, 3)) + [0, 0, 4]).astype(np.float32)
    Rs, ts = [], []
    for i in range(K):
        Ti = SE3.exp(T(np.float32([0.4 * i, 0.02 * i, 0, 0, 0.05 * i, 0])))
        Rs.append(Ti.R)
        ts.append(Ti.t)
    R, t = torch.stack(Rs), torch.stack(ts)
    oc = torch.arange(M, device=dev).repeat(P, 1)
    pc = torch.einsum("pmij,pj->pmi", R[oc], T(p_gt)) + t[oc]
    noise = rng.normal(0, 0.02, (K, 6)).astype(np.float32)
    noise[:2] = 0
    Tn = SE3.exp(T(noise)) * SE3(R, t)
    var = T(np.array([False, False, True, True]))
    prob = BAProblem(Tn.R, Tn.t, var,
                     T(p_gt + rng.normal(0, 0.02, (P, 3)).astype(np.float32)),
                     T(np.ones(P, bool)), oc.to(torch.int32),
                     pc / torch.linalg.vector_norm(pc, dim=-1, keepdim=True),
                     torch.zeros((P, M), dtype=torch.int32, device=dev),
                     pc[..., 2] > 0.1)
    pts = ("p_w", "p_valid", "obs_cam", "obs_f", "obs_level", "obs_mask")
    local = prob._replace(**dict(zip(pts, sharded.shard_on(
        mesh, tuple(getattr(prob, k) for k in pts)))))
    (Rm, tm, pm, _), coll = counted(lambda: distributed_ba_solve(
        mesh, local, n_iter=8))
    R1, t1, p1, _ = distributed_ba_solve(mesh, prob, n_iter=8, axis="")
    # the per-camera sums are index_add atomics on the card: the same
    # solve run twice differs in the last bits
    R2, t2, p2, _ = distributed_ba_solve(mesh, prob, n_iter=8, axis="")
    ref = solve_ba(prob, n_iter=8, huber_width=0.01)
    res["ba"] = {"gap": max(gap(Rm, R1), gap(tm, t1), gap(pm, p1)),
                 "replay_gap": max(gap(R2, R1), gap(t2, t1), gap(p2, p1)),
                 "scale": float(torch.abs(p1).max()),
                 "gap_solve_ba_t": gap(tm, ref.t), "collectives": len(coll)}

    # streams and the sharded step on the bench scene
    cfg = bench_cfg("fast")
    ds = SyntheticDataset(n_frames=N_FRAMES, shape=SHAPE, device=dev,
                          **SCENE_KW)
    ncx, ncy = grid_dims(SHAPE[1], SHAPE[0], cfg.grid_size)
    img0, depth0, T00 = ds.frame(0)
    s0 = fused.seed_first_frame_with_depth(img0, T00.inverse(), depth0,
                                           ds.cam, cfg, img_shape=SHAPE,
                                           device=dev)
    img1 = ds.frame(1)[0]
    (_, om), coll = counted(lambda: streams.multistream_step(
        mesh, streams.stack_states([s0]), img1[None], ds.cam, cfg, ncx,
        ncy, SHAPE))
    _, o1 = fused.vo_step(s0, img1, ds.cam, cfg, ncx, ncy, SHAPE)
    res["multistream"] = {"gap": gap(om.t_wc[0], o1.t_wc),
                          "collectives": len(coll)}
    # vo_step_mesh is graphed: its first call runs the step (the log gets
    # its collectives) and captures it with them, later calls replay them
    # (the log gets none; the profiler sees what the card ran)
    sm, s1, se = s0, s0, s0
    gaps, gaps_eager, colls, kfs = [], [], [], []
    for i in range(1, MESH_FRAMES + 1):
        img = ds.frame(i)[0]
        (sm, om), coll = counted(lambda: vo_step_mesh(
            mesh, sm, img, ds.cam, cfg, ncx, ncy, SHAPE))
        s1, o1 = fused.vo_step(s1, img, ds.cam, cfg, ncx, ncy, SHAPE)
        se, oe = _eager_step(se, img, ds.cam, cfg, ncx, ncy, SHAPE)
        gaps.append(max(gap(om.t_wc, o1.t_wc), gap(om.R_fw, o1.R_fw)))
        gaps_eager.append(max(gap(om.t_wc, oe.t_wc), gap(om.R_fw, oe.R_fw)))
        colls.append(len(coll))
        kfs.append([bool(om.is_keyframe), bool(o1.is_keyframe),
                    bool(oe.is_keyframe)])
    img = ds.frame(MESH_FRAMES + 1)[0]
    (_, _), coll = counted(lambda: _raw_profile(torch, lambda: vo_step_mesh(
        mesh, sm, img, ds.cam, cfg, ncx, ncy, SHAPE)))
    _, mesh_ev = _raw_profile(torch, lambda: vo_step_mesh(
        mesh, sm, img, ds.cam, cfg, ncx, ncy, SHAPE))
    _, single_ev = _raw_profile(torch, lambda: fused.vo_step(
        s1, img, ds.cam, cfg, ncx, ncy, SHAPE))
    meshes = [k[4] is not None for k, *_ in graphed.slots()]
    res["vo_step_mesh"] = {"frames": MESH_FRAMES, "gap": max(gaps),
                           "gap_eager": max(gaps_eager),
                           "collectives_per_step": colls,
                           "collectives_profiled_replay": len(coll),
                           "keyframes": kfs, "replay": mesh_ev,
                           "single_device_replay": single_ev,
                           "slots_with_mesh": sum(meshes),
                           "slots_without": len(meshes) - sum(meshes)}
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    dist.destroy_process_group()
    print("# mesh " + json.dumps(res), flush=True)
    return 0


def _mesh_phase(root: Path) -> dict:
    """Phase 22: ``_mesh_world`` in a subprocess, as a user starts a rank,
    and its figures checked here."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke._mesh_world())"],
        cwd=root, capture_output=True, text=True, timeout=MESH_TIMEOUT_S)
    line = [x for x in out.stdout.splitlines() if x.startswith("# mesh ")]
    assert out.returncode == 0 and line, \
        f"mesh world failed: rc {out.returncode}\n{out.stdout[-3000:]}\n" \
        f"{out.stderr[-3000:]}"
    res = json.loads(line[-1][len("# mesh "):])
    res["phase_seconds"] = time.perf_counter() - t0
    vm = res["vo_step_mesh"]
    print(f"# mesh programs on {res['backend']} (world size "
          f"{res['world_size']}, mesh {res['mesh']}, {res['device']}): pose "
          f"gap {res['pose']['gap']:.2e} ({res['pose']['collectives']} "
          f"collectives), seeds {res['seeds']['gap']:.2e} (n_conv "
          f"{res['seeds']['n_conv']}), BA {res['ba']['gap']:.2e} "
          f"({res['ba']['collectives']} collectives; the same solve run "
          f"twice {res['ba']['replay_gap']:.2e}, points up to "
          f"{res['ba']['scale']:.2f} m; solve_ba "
          f"{res['ba']['gap_solve_ba_t']:.2e}), multistream_step "
          f"{res['multistream']['gap']:.2e} ("
          f"{res['multistream']['collectives']} collectives), graphed "
          f"vo_step_mesh {vm['gap']:.2e} from graphed vo_step and "
          f"{vm['gap_eager']:.2e} from the eager body over {MESH_FRAMES} "
          f"frames (collectives logged per call {vm['collectives_per_step']}"
          f": the first call runs the step, the rest replay the graph); a "
          f"replay against one of vo_step: NCCL kernels "
          f"{vm['replay']['nccl_kernels']} / "
          f"{vm['single_device_replay']['nccl_kernels']}, device copies "
          f"{vm['replay']['memcpy']} / "
          f"{vm['single_device_replay']['memcpy']}, device ops "
          f"{vm['replay']['device_ops']} / "
          f"{vm['single_device_replay']['device_ops']}, K1 "
          f"{vm['replay']['tile_gather']}, K2 {vm['replay']['sparse_align']}"
          f", host aten ops {vm['replay']['host_aten_ops']}; slots with the "
          f"mesh {vm['slots_with_mesh']}, without {vm['slots_without']}; "
          f"{res['phase_seconds']:.1f} s", flush=True)
    print("# not run: NCCL across GPUs (this machine has one card; the mesh "
          "programs ran across 4 gloo ranks on the CPU in "
          "tests/test_torch_parallel.py)", flush=True)
    assert res["backend"] == "nccl" and res["world_size"] == 1
    for k in ("pose", "seeds", "multistream", "vo_step_mesh"):
        assert res[k]["gap"] <= MESH_TOL, (k, res[k])
    # BA's points lie ~5 m out: 1e-6 of their size (float32 rounding of the
    # atomic sums, which part the single-device solve from itself too)
    assert res["ba"]["gap"] <= MESH_TOL * max(1.0, res["ba"]["scale"]), \
        res["ba"]
    assert res["seeds"]["n_conv"] == res["seeds"]["n_conv_single"] > 0
    assert res["pose"]["terr_m"] < 1e-3 and res["ba"]["gap_solve_ba_t"] < 5e-4
    assert res["multistream"]["collectives"] == 0
    assert vm["gap_eager"] <= MESH_TOL, vm
    assert vm["collectives_per_step"][0] > 0 \
        and not any(vm["collectives_per_step"][1:]) \
        and vm["collectives_profiled_replay"] == 0, vm
    assert all(len(set(k)) == 1 for k in vm["keyframes"]), vm["keyframes"]
    assert (vm["replay"]["tile_gather"], vm["replay"]["sparse_align"]) \
        == (K1_PER_FRAME, 1), vm["replay"]
    assert vm["replay"]["host_aten_ops"] < GRAPH_MAX_CALL_OPS, vm["replay"]
    # the mesh is part of a slot's key: the mesh step has a slot of its own
    assert vm["slots_with_mesh"] == 1 and vm["slots_without"] >= 1, vm
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
        state, out = _eager_step(state, img, cam, cfg_a, ncx, ncy, shape)
        outs.append(out)
    launches_a = _read_counts()
    pos = np.stack([o.t_wc.cpu().numpy() for o in outs])
    terr_a = np.linalg.norm(pos - gt[:SLICE_A_FRAMES], axis=-1)
    assert not any(bool(o.failed) for o in outs), "slice A: a frame failed"
    assert launches_a == {"tile_gather": SLICE_A_FRAMES,
                          "sparse_align": SLICE_A_FRAMES}, launches_a
    assert np.median(terr_a) < 0.01, "slice A lost the ground truth"
    ops_a, ms_a, _, _ = _device_profile(
        torch, lambda: _eager_step(state, imgs[SLICE_A_FRAMES], cam, cfg_a,
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
            state, out = _eager_step(state, img, cam, cfg, ncx, ncy, shape)
            outs.append(out)
            # every SNAP_EVERY frames, and the streams' starts of phase 21
            if i % SNAP_EVERY == 0 or (preset == "fast" and i in
                                       stream_starts):
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
            st, _ = _eager_step(st, imgs[j - 1], cam, cfg, ncx, ncy, shape)
        steps = {}
        for label, j in (("keyframe", k), ("other", k + 1)):
            step = functools.partial(_eager_step, st, imgs[j - 1], cam, cfg,
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

    stream_starts = range(0, STREAM_EVERY * (max(STREAM_BS) + 1),
                          STREAM_EVERY)
    fast, fast_outs, fast_snaps = run_path("fast")
    stream_snaps = {i: fast_snaps[i] for i in stream_starts}
    stage_snap = fast_snaps[STAGE_FROM]
    accurate, acc_outs, acc_snaps = run_path("accurate")
    # phase 23's starts: the state before each preset's first keyframe
    donated_starts = {}
    for p, sm, outs_p, snaps_p in (("fast", fast, fast_outs, fast_snaps),
                                   ("accurate", accurate, acc_outs,
                                    acc_snaps)):
        k = sm["keyframes"][0]
        assert k + DONATED_PAST <= PRESET_FRAMES[p], (p, k)
        s = max(i for i in snaps_p if i < k)
        donated_starts[p] = (s, snaps_p[s], outs_p, k)
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

    def handler_run(preset, n, events_from):
        return _handler_run(scene, cfgs[preset], n, cam, imgs, (img0, depth0),
                            preset, events_from)

    handler, h_infos, h_pos, h_snaps = handler_run("fast", len(imgs),
                                                   EVENTS_FROM)
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
          f"{handler['host_syncs_per_frame']:.2f} host syncs per frame; "
          f"steps {json.dumps(handler['steps'])}", flush=True)

    # --- 8. FrameHandler, accurate, to the first keyframe and past it ------
    phase(8)
    handler_acc, acc_infos, _, _ = handler_run(
        "accurate", HANDLER_ACC_FRAMES, HANDLER_ACC_FRAMES - EVENTS_WINDOW)
    acc_kf = handler_acc["keyframes"][0]
    assert "local_ba" in acc_infos[acc_kf - 1], "no local BA at the keyframe"
    lim = LIMITS_MM["accurate"]
    assert handler_acc["median_terr_mm"] <= lim[0] \
        and handler_acc["max_terr_mm"] <= lim[1], handler_acc

    # --- 9. the bench.py --bootstrap protocol (fast) ------------------------
    phase(9)
    cfg = cfgs["fast"]

    def bootstrap_run():
        """(handler, bootstrap frame, inliers, add_image calls)."""
        fh = FrameHandler(cam, cfg, shape, device=dev)
        fh.add_image(img0, 0.0)
        i, n_calls = 0, 1
        while i + BOOT_STRIDE < N_FRAMES - 1:
            i += BOOT_STRIDE
            info = fh.add_image(imgs[i - 1], i / 50.0)
            n_calls += 1
            if fh.stage == "default":
                return fh, i, info["init_inliers"], n_calls
        raise AssertionError("the bootstrap never reached the default stage")
    # a first run captures the bootstrap's stage graphs; the second, which
    # replays them, is the run checked, timed (under the profiler) and
    # counted
    t0 = time.perf_counter()
    bootstrap_run()
    warm_s = time.perf_counter() - t0
    _reset_counts()

    def timed_bootstrap():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bootstrap_run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    ((fh, i_boot, inliers, n_calls), boot_s), ev = _raw_profile(
        torch, timed_bootstrap)
    boot_launches = _run_launches()
    boot_events = {k_: ev[k_] for k_ in boot_launches}
    boot_misses = _seen_by_profiler(ev, boot_launches, "bootstrap_handler")
    state = fused.state_from_handler(fh)
    # graphed vo_step: the wrappers count the slot's capture call at most;
    # the kernels of the last GRAPH_PROFILED frames are profiler events
    _reset_counts()

    def track(frames):
        nonlocal state
        outs = []
        for j in frames:
            state, out = fused.vo_step(state, imgs[j - 1], cam, cfg, ncx,
                                       ncy, shape)
            outs.append(out)
        return outs
    b_outs = track(range(i_boot + 1, N_FRAMES - GRAPH_PROFILED))
    track_wrapped = _read_counts()
    (last, ev), track_want = _counted(lambda: _raw_profile(torch, lambda: track(
        range(N_FRAMES - GRAPH_PROFILED, N_FRAMES))))
    b_outs += last
    track_launches = {k_: ev[k_] for k_ in ("tile_gather", "sparse_align")}
    assert track_launches == track_want \
        and track_want["sparse_align"] == GRAPH_PROFILED \
        and track_want["tile_gather"] <= K1_PER_FRAME * GRAPH_PROFILED, \
        (track_launches, track_want)
    est = torch.stack([o.t_wc for o in b_outs]).cpu().numpy()
    b_failed = [i_boot + 1 + q for q, o in enumerate(b_outs)
                if bool(o.failed)]
    n_bench = BOOT_CHUNK + BOOT_CHUNK * (
        (N_FRAMES - 1 - i_boot - BOOT_CHUNK) // BOOT_CHUNK)
    ate_b = ate_rmse(gt[i_boot:i_boot + n_bench], est[:n_bench])
    ate_all = ate_rmse(gt[i_boot:], est)
    bootstrap = {"frame": i_boot, "inliers": inliers, "add_image_calls":
                 n_calls, "seconds": boot_s, "capture_run_seconds": warm_s,
                 "events": boot_events, "profiler_misses": boot_misses,
                 "bench_window": [i_boot + 1, i_boot + n_bench],
                 "ate_median_mm": ate_b["median"] * 1e3,
                 "ate_median_mm_to_end": ate_all["median"] * 1e3,
                 "scale": ate_b["scale"], "failed": b_failed,
                 "launches": boot_launches, "launches_per_call":
                 {k_: v / n_calls for k_, v in boot_launches.items()},
                 "track_launches": track_launches,
                 "track_launches_per_frame":
                 {k_: v / GRAPH_PROFILED for k_, v in track_launches.items()},
                 "track_wrapper_launches": track_wrapped}
    print(f"# bootstrap protocol: default stage at frame {i_boot} "
          f"({inliers} inliers, {n_calls} add_image calls, {boot_s:.1f} s "
          f"under the profiler, {warm_s:.1f} s in the run that captured); "
          f"ATE median {bootstrap['ate_median_mm']:.4f} mm over frames "
          f"{i_boot + 1}-{i_boot + n_bench} (limit {BOOT_ATE_LIMIT_MM:.4f}), "
          f"{bootstrap['ate_median_mm_to_end']:.4f} mm to frame "
          f"{N_FRAMES - 1}; scale {ate_b['scale']:.4f}; failed {b_failed}; "
          f"launches {boot_launches}, kernel events {boot_events}, then "
          f"graphed vo_step: kernel events "
          f"{track_launches} over the last {GRAPH_PROFILED} frames "
          f"(wrappers before them: {track_wrapped})", flush=True)
    assert not b_failed, b_failed
    assert bootstrap["ate_median_mm"] <= BOOT_ATE_LIMIT_MM, bootstrap

    # --- 10. relocalization, relocalize_frame_at_pose, global BA -----------
    phase(10)
    h = _snapshot(h_snaps[RELOC_FROM])
    black = torch.zeros(shape, device=dev)

    def relocalize():
        r1 = h.add_image(black, 0.0)
        assert r1["result"] == "failure" and h.stage == "relocalizing", r1
        r2 = h.add_image(imgs[RELOC_FROM], 0.0)
        err = float(np.linalg.norm(
            h.last_frame.T_f_w.inverse().t.cpu().numpy() - gt[RELOC_FROM]))
        assert r2["result"] != "failure" and h.stage == "default", r2
        kf = h.map.kf
        kf_id = int(kf.frame_id[kf.active].max())
        at_pose = h.relocalize_frame_at_pose(
            kf_id, SE3.identity(device=dev), imgs[RELOC_FROM + 1], 0.0)
        assert at_pose and h.stage == "default"
        return r1, r2, err, kf_id, at_pose
    # kernel events: the stages replay CUDA graphs
    (r1, r2, reloc_err, kf_id, at_pose), ev = _raw_profile(torch, relocalize)
    at_pose_err = float(np.linalg.norm(
        h.last_frame.T_f_w.inverse().t.cpu().numpy() - gt[RELOC_FROM + 1]))
    reloc_launches = {k_: ev[k_] for k_ in ("tile_gather", "sparse_align")}
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
          f"rotations by up to {moved:.2e}; kernel events {reloc_launches}",
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

    # --- 13-18 write their files under build/chip_smoke/ -------------------
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
        scene, cfgs["fast"], atan, "ATAN", ATAN_FRAMES, ATAN_LIMITS_MM)

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
    dt_card, ev = _raw_profile(
        torch, lambda: track_on(resume(work / "card.npz", dev), dev))
    ckpt_launches = {k_: ev[k_] for k_ in ("tile_gather", "sparse_align")}
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

    # --- 18. the live entry point, as a subprocess ---------------------------
    phase(18)
    live = _live_phase(root, work, t_all)
    shutil.rmtree(work)

    # --- 19. the left-out functions, card against CPU ----------------------
    phase(19)
    surface = _surface_phase(ds, dev)
    print("# not run on the card: tools/dashboard and the analysis plots "
          "(the machine has no matplotlib; tests/test_torch_tools.py holds "
          "them to the JAX package on the CPU)", flush=True)

    # --- 21. B camera streams in one step ----------------------------------
    phase(21)
    streams_b = _streams_phase(stream_snaps, imgs, fast_outs, cam,
                               cfgs["fast"], (ncx, ncy), shape)
    del stream_snaps

    # --- 22. the mesh programs on NCCL, world size 1, as a subprocess ------
    phase(22)
    mesh = _mesh_phase(root)
    print(f"# phases 21-22 took {streams_b['seconds']:.1f} s and "
          f"{mesh['phase_seconds']:.1f} s", flush=True)

    # --- 23. the donated step, both presets ----------------------------------
    phase(23)
    donated = _donated_phase(donated_starts, imgs, cam, cfgs, (ncx, ncy),
                             shape)
    del donated_starts

    # --- 24. stage attribution: the step under each code-level stub --------
    phase(24)
    stages = _stage_phase(stage_snap, imgs, cam, cfgs["fast"], (ncx, ncy),
                          shape)

    # --- 25. the donated step as one CUDA graph, both presets --------------
    phase(25)
    graph = _graph_phase(seeded, imgs, {"fast": fast_outs,
                                        "accurate": acc_outs},
                         cam, cfgs, (ncx, ncy), shape, gt)

    # --- 26. the entries that keep their input as CUDA graphs -----------
    phase(26)
    kept = _kept_phase(seeded, imgs, {"fast": fast_outs,
                                      "accurate": acc_outs},
                       cam, cfgs, (ncx, ncy), shape, gt)
    print(f"# phases 23-26 took {donated['seconds']:.1f} s, "
          f"{stages['seconds']:.1f} s, {graph['seconds']:.1f} s and "
          f"{kept['seconds']:.1f} s", flush=True)

    # --- 27. FrameHandler's stages as CUDA graphs against eager -------------
    phase(27)
    handler_graphs = _handler_graph_phase(scene, cfgs, cam, imgs,
                                          (img0, depth0))
    print(f"# phase 27 took {handler_graphs['seconds']:.1f} s", flush=True)

    # --- 20. the lines (after phases 21-26) ----------------------------------
    phase(20)
    paths = {"slice_a": (launches_a, SLICE_A_FRAMES),
             "fast": (fast["launches"], fast["frames"]),
             "accurate": (accurate["launches"], accurate["frames"]),
             "handler_fast": (handler["launches"], handler["launch_frames"]),
             "handler_accurate": (handler_acc["launches"],
                                  handler_acc["launch_frames"]),
             "bootstrap_handler": (boot_launches, n_calls),
             "bootstrap_vo_step": (track_launches, GRAPH_PROFILED),
             "relocalization": (reloc_launches, 3),
             "handler_atan": (handler_atan["launches"],
                              handler_atan["launch_frames"]),
             "handler_omni": (handler_omni["launches"],
                              handler_omni["launch_frames"]),
             "driver_blender": (driver_blender["launches"],
                                driver_blender["launch_frames"]),
             "driver_euroc": (driver_euroc["launches"],
                              driver_euroc["launch_frames"]),
             "checkpoint_atan": (ckpt_launches, CKPT_FRAMES),
             "live": (live["launches"], live["launch_frames"]),
             "surface_align_padded": (surface["launches"]["align_padded"], 1),
             "surface_epipolar_align_1d":
                 (surface["launches"]["epipolar_align_1d"], 1),
             "fast_donated": (donated["fast"]["launches"],
                              donated["fast"]["n_frames"]),
             "accurate_donated": (donated["accurate"]["launches"],
                                  donated["accurate"]["n_frames"]),
             "fast_graphed_scan": (graph["fast"]["launches"],
                                   graph["fast"]["profiled_frames"]),
             "accurate_graphed_scan": (graph["accurate"]["launches"],
                                       graph["accurate"]["profiled_frames"]),
             "mesh_vo_step": (mesh["vo_step_mesh"]["replay"], 1),
             "streams_eager_b8": (streams_b["eager"]["launches"],
                                  streams_b["eager"]["steps"])}
    # the kept-state entries (phase 26), profiler events per replayed frame
    # and per call
    for p_ in ("fast", "accurate"):
        paths[f"{p_}_graphed_vo_scan"] = (kept[p_]["per_replayed_frame"], 1)
        paths[f"{p_}_graphed_vo_step"] = (kept[p_]["vo_step_call"], 1)
    # phase 27: the handler's window, graphed and eager (profiler events)
    for p_ in ("fast", "accurate"):
        for w_ in ("graphed", "eager"):
            paths[f"handler_{w_}_window_{p_}"] = (
                handler_graphs[p_]["by_way"][w_], HG_WINDOW)
    # graphed batched steps: kernel events per replayed batched step,
    # whatever the streams
    paths.update({f"streams_vmapped_b{B}": (r["profiled_launches_per_step"],
                                            1)
                  for B, r in streams_b["by_b"].items()})
    # the reference runs K2 for pinhole cameras only (pallas_align.py:53):
    # the ATAN and Omni paths align with the plain loop; the bootstrap's
    # two stages before tracking align nothing
    no_k2 = {"bootstrap_handler", "handler_atan", "handler_omni",
             "checkpoint_atan", "surface_align_padded",
             "surface_epipolar_align_1d"}
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
         "by_shape": k1_shapes, "batched": streams_b["k1_batched"]},
        {"name": "sparse_align", "route": "cuda",
         "source": "rpg_svo_tpu_torch/csrc/sparse_align.cu",
         "replaces": "rpg_svo_tpu/ops/pallas_align.py:58",
         "launches": fast["launches"]["sparse_align"],
         "max_abs_err": max(k2_err, streams_b["k2_batched"]["max_abs_err"]),
         "ms": statistics.median(r["ms"] for r in k2_fast),
         "plain_ms": k2_fast[0]["plain_ms"],
         "bound_ms": statistics.median(r["bound_ms"] for r in k2_fast),
         "bound_by": k2_fast[0]["bound_by"], "library_ms": None,
         "launches_by_path": k2_by, "launches_per_frame": k2_pf,
         "device_ms_per_step": main_ms("sparse_align"),
         "by_trial": k2_runs, "batched": streams_b["k2_batched"]},
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
               "checkpoint": ckpt, "live": live, "surface": surface,
               "streams": streams_b, "mesh": mesh, "donated": donated,
               "stages": stages, "graphed": graph, "kept": kept,
               "handler_graphs": handler_graphs,
               "phase_start_s": phase_s,
               "seconds": time.perf_counter() - t_start}
    # the whole summary also as a file: the printed line outgrows the tail
    # of the output that a remote run returns
    (root / "chiprun_out").mkdir(exist_ok=True)
    (root / "chiprun_out" / "chip_smoke_summary.json").write_text(
        json.dumps(summary, indent=1))
    print("# summary " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
