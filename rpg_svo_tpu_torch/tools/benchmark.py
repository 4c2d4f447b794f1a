"""Offline benchmark driver: run the pipeline over a dataset, trace,
evaluate.

Port of ``rpg_svo_tpu/tools/benchmark.py`` (BenchmarkNode,
svo_ros/src/benchmark_node.cpp:133-256, and the svo_analysis benchmark and
evaluate drivers, scripts/benchmark.py:18-106): runs the port's
FrameHandler over a dataset, writes the TUM trajectory and the SVO_TRACE
csv, and evaluates ATE and RPE against the ground truth.  Runs on the card
unless ``--device`` names another.

Usage:
  python -m rpg_svo_tpu_torch.tools.benchmark --dataset synthetic \\
      --frames 100 --out <dir>
  python -m rpg_svo_tpu_torch.tools.benchmark --dataset tum --path <dir> ...
  python -m rpg_svo_tpu_torch.tools.benchmark --experiment <yaml> ...
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch


def _feature_depth_errors(fh, depth_map: np.ndarray):
    """|estimated - true| depth along the ray of the current frame's
    features with a point (BenchmarkNode::traceDepthError,
    svo_ros/src/benchmark_node.cpp:113-131), the truth read from the depth
    map at the feature pixel."""
    lf = fh.last_frame
    px = lf.feat_px.cpu().numpy()
    pid = lf.feat_point.cpu().numpy()
    ok = lf.feat_valid.cpu().numpy() & (pid >= 0)
    if not ok.any():
        return []
    pos = fh.map.pt.pos.cpu().numpy()[np.clip(pid, 0, None)]
    R, t = lf.R.cpu().numpy(), lf.t.cpu().numpy()
    z = np.linalg.norm(pos @ R.T + t, axis=-1)
    u = np.clip(np.round(px[:, 0]).astype(int), 0, depth_map.shape[1] - 1)
    v = np.clip(np.round(px[:, 1]).astype(int), 0, depth_map.shape[0] - 1)
    gt_z = depth_map[v, u]
    return np.abs(z - gt_z)[ok & (gt_z > 0)].tolist()


def _host(img) -> np.ndarray:
    return img.cpu().numpy() if isinstance(img, torch.Tensor) \
        else np.asarray(img)


def run(args, cfg=None, cam_override=None):
    """One dataset run; writes the outputs under args.out and returns the
    report.  The device is args.device (``cuda`` where it is unset)."""
    from rpg_svo_tpu_torch import resolve_device
    from rpg_svo_tpu_torch.analysis.ate import associate, ate_rmse
    from rpg_svo_tpu_torch.analysis.rpe import rpe as rpe_eval
    from rpg_svo_tpu_torch.config import accurate_preset, fast_preset
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    from rpg_svo_tpu_torch.geometry.cameras import PinholeCamera
    from rpg_svo_tpu_torch.geometry.se3 import quat_to_rot, rot_to_quat
    from rpg_svo_tpu_torch.io.trace import TraceWriter
    from rpg_svo_tpu_torch.io.trajectory import pose_entry, write_tum
    from rpg_svo_tpu_torch.viz import Info, InfoStream, status_line

    dev = resolve_device(getattr(args, "device", None))
    os.makedirs(args.out, exist_ok=True)
    if cfg is None:
        cfg = accurate_preset() if args.preset == "accurate" \
            else fast_preset()
        cfg = cfg.replace(grid_size=args.grid_size)
    if getattr(args, "min_fts", 0):
        # quality gate for small images (the reference's tests change the
        # Config the same way, svo/test/test_sparse_img_align.cpp:156-157)
        cfg = cfg.replace(quality_min_fts=args.min_fts)
    cam_p = [float(x) for x in args.cam.split(",")] if args.cam else None

    gt = None  # (ts, t (N, 3), q (N, 4) xyzw)
    if args.dataset == "synthetic":
        from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset
        ds = SyntheticDataset(n_frames=args.frames, trajectory="circle",
                              radius=0.25, revolutions=0.6, device=dev)
        cam = ds.cam
        shape = ds.shape

        def frames():
            for i in range(len(ds)):
                img, depth, T = ds.frame(i)
                yield i / 50.0, img, (depth if i == 0 else None), T
        gt = (np.arange(len(ds)) / 50.0,
              np.stack([p.t.cpu().numpy() for p in ds.poses]),
              np.stack([rot_to_quat(p.R).cpu().numpy() for p in ds.poses]))
    elif args.dataset == "tum":
        from rpg_svo_tpu_torch.io.datasets import TUMDataset
        ds = TUMDataset(args.path)
        shape = ds.frame(0)[0].shape
        # fr2 intrinsics unless --cam fx,fy,cx,cy
        cam = PinholeCamera.make(shape[1], shape[0],
                                 *(cam_p or [520.9, 521.0, 325.1, 249.7])[:4])
        gt = ds.gt
        frames = _file_frames(ds, args.frames)
    elif args.dataset == "euroc":
        from rpg_svo_tpu_torch.io.datasets import EuRoCDataset
        ds = EuRoCDataset(args.path)
        shape = ds.frame(0)[0].shape
        cam_p = cam_p or [458.654, 457.296, 367.215, 248.375, -0.2834,
                          0.0739, 0.0002, 1.76e-5]
        cam = PinholeCamera.make(shape[1], shape[0], *cam_p[:8])
        gt = ds.gt
        frames = _file_frames(ds, args.frames)
    elif args.dataset == "blender":
        # the reference's blender protocol (benchmark_node.cpp:183-256):
        # ground-truth poses and depth maps, frame 0 seeded from depth
        from rpg_svo_tpu_torch.io.datasets import BlenderDataset
        ds = BlenderDataset(args.path)
        shape = ds.frame(0)[0].shape
        cam = PinholeCamera.make(shape[1], shape[0],
                                 *(cam_p or [315.5, 315.5, 376.0, 240.0])[:4])
        n = min(len(ds), args.frames)
        gt_T = [ds.frame(i)[1] for i in range(n)]
        gt = (np.arange(n, dtype=np.float64) / 50.0,
              np.stack([T.t.numpy() for T in gt_T]),
              np.stack([rot_to_quat(T.R).numpy() for T in gt_T]))

        def frames():
            for i in range(n):
                img, T, _ = ds.frame(i)
                yield i / 50.0, img, \
                    (ds.depth(i, shape) if i == 0 else None), T
    else:
        raise SystemExit(f"unknown dataset {args.dataset}")

    if cam_override is not None:
        cam = cam_override

    if args.noise_sigma > 0:
        # image noise on the host, drawn as the JAX package draws it
        # (benchmark_node.cpp:166-176, dataset_noise_sigma)
        rng = np.random.default_rng(args.noise_seed)
        base_frames = frames

        def frames():  # noqa: F811
            for ts, img, d0, T_gt in base_frames():
                img = _host(img)
                noisy = img + rng.normal(0.0, args.noise_sigma, img.shape)
                yield ts, np.clip(noisy, 0.0, 255.0).astype(np.float32), \
                    d0, T_gt

    fh = FrameHandler(cam, cfg, img_shape=shape, device=dev)
    tracer = TraceWriter(args.out, "trace")
    stream = InfoStream()
    entries = []
    est_ts = []
    # per-frame error traces (benchmark_node tracePoseError and
    # traceDepthError, benchmark_node.cpp:91-131)
    terr_rows, rerr_rows, depth_errs = [], [], []

    t_start = time.perf_counter()
    frame_i = 0
    for ts, img, depth0, T_gt in frames():
        if frame_i == 0 and depth0 is not None and args.seed_first_frame:
            fh.set_first_frame_with_depth(img, T_gt.inverse(), depth0, ts)
            entries.append(pose_entry(ts, T_gt))
            est_ts.append(ts)
            frame_i += 1
            continue
        info = fh.add_image(img, ts)
        tracer.log_frame(info)
        rec = Info.from_frame_info(info, fh.quality)
        stream.push(rec)
        if args.verbose:
            print(status_line(rec, stream.fps))
        if fh.stage == "default":
            T_wc = fh.last_frame.T_f_w.inverse()
            entry = pose_entry(ts, T_wc)
            entries.append(entry)
            est_ts.append(ts)
            if T_gt is not None:
                dt_vec = entry[1] - T_gt.t.cpu().numpy()
                terr_rows.append((ts, float(np.linalg.norm(dt_vec)),
                                  *dt_vec.tolist()))
                dR = T_gt.R.cpu().numpy().T @ T_wc.R.cpu().numpy()
                rerr_rows.append((ts, float(np.arccos(np.clip(
                    (np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))))
            if args.dataset == "blender" and args.trace_depth:
                dm = ds.depth(frame_i, shape)
                if dm is not None:
                    depth_errs.extend(_feature_depth_errors(fh, dm))
        frame_i += 1
    wall = time.perf_counter() - t_start

    traj_path = os.path.join(args.out, "traj_estimate.txt")
    write_tum(traj_path, entries)
    trace_path = tracer.flush()
    if terr_rows:
        with open(os.path.join(args.out, "translation_error.txt"), "w") as f:
            for row in terr_rows:
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
        with open(os.path.join(args.out, "orientation_error.txt"), "w") as f:
            for row in rerr_rows:
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
    if depth_errs:
        with open(os.path.join(args.out, "depth_error.txt"), "w") as f:
            for e in depth_errs:
                f.write(f"{e:.9f}\n")
    if args.ply:
        from rpg_svo_tpu_torch.io.ply import map_points_ply
        map_points_ply(os.path.join(args.out, "map_points.ply"), fh.map)

    report = {"frames": len(stream.infos), "wall_s": round(wall, 3),
              "fps": round(len(stream.infos) / max(wall, 1e-9), 2),
              "trajectory": traj_path, "trace": trace_path}
    if depth_errs:
        from rpg_svo_tpu_torch.analysis.depth import depth_error_stats
        report["depth_error"] = depth_error_stats(np.asarray(depth_errs))
    if gt is not None and len(entries) > 3:
        est_t = np.stack([e[1] for e in entries])
        est_q = np.stack([e[2] for e in entries])
        ia, ib = associate(np.asarray(est_ts), gt[0])
        if len(ia) > 3:
            report["ate"] = ate_rmse(gt[1][ib], est_t[ia])

            def rot(q):
                return quat_to_rot(torch.as_tensor(
                    np.asarray(q, np.float32))).numpy()
            report["rpe_delta1"] = rpe_eval(gt[1][ib], rot(gt[2][ib]),
                                            est_t[ia], rot(est_q[ia]),
                                            delta=1)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


def run_experiment(args):
    """The reference's experiment protocol: one YAML names the algorithm
    parameters and the datasets; each dataset directory carries its own
    dataset_params.yaml (svo_analysis/scripts/benchmark.py:18-106)."""
    from rpg_svo_tpu_torch.io.experiment import (
        apply_param_overrides, camera_from_params, load_algo_config,
        load_dataset_params, load_experiment)
    exp = load_experiment(args.experiment)
    exp_dir = os.path.dirname(os.path.abspath(args.experiment))
    root = args.dataset_dir or os.environ.get("SVO_DATASET_DIR") or exp_dir
    base_cfg = load_algo_config(exp.param_settings,
                                search_dirs=[root, exp_dir])
    base_cfg = apply_param_overrides(base_cfg, exp.extra)
    reports = {}
    for name in (exp.datasets or ["synthetic"]):
        sub = copy.copy(args)
        sub.out = os.path.join(args.out,
                               f"{exp.label}_{name}".replace(" ", "_"))
        cam = None
        cfg = base_cfg
        if name == "synthetic":
            sub.dataset = "synthetic"
        else:
            ddir = os.path.join(root, name)
            if not os.path.isdir(ddir):
                raise SystemExit(f"dataset directory not found: {ddir}")
            dp = load_dataset_params(ddir)
            cfg = apply_param_overrides(cfg, dp)
            if "cam0" in dp or "cam_model" in dp:
                cam = camera_from_params(dp)
            if dp.get("dataset_noise_sigma"):
                sub.noise_sigma = float(dp["dataset_noise_sigma"])
            sub.path = ddir
            if dp.get("dataset_is_blender"):
                sub.dataset = "blender"
            elif os.path.exists(os.path.join(ddir, "rgb.txt")):
                sub.dataset = "tum"
            elif os.path.isdir(os.path.join(ddir, "mav0")):
                sub.dataset = "euroc"
            else:
                sub.dataset = "blender"
        reports[name] = run(sub, cfg=cfg, cam_override=cam)
    out = os.path.join(args.out, "experiment_report.json")
    with open(out, "w") as f:
        json.dump({"label": exp.label, "datasets": reports}, f, indent=2)
    print(f"# experiment report: {out}")
    return reports


def _file_frames(ds, max_frames: int):
    """Frame iterator over a file dataset: decoded ahead on the native
    prefetch pool (native/loader.cpp), or one by one where the native
    library is unavailable; prints which source serves."""
    from rpg_svo_tpu_torch.io.datasets import NativePrefetchingSource
    from rpg_svo_tpu_torch.native import loader as native_loader
    n = min(len(ds), max_frames)

    def gen():
        try:
            source = NativePrefetchingSource(ds)
        except RuntimeError:   # the native library is unavailable
            source = None
        print("# image source: " + (
            "serial decode" if source is None else
            "native prefetcher (PNG: "
            f"{'libpng' if native_loader.has_png() else 'none'})"),
            flush=True)
        if source is None:
            for i in range(n):
                img, ts = ds.frame(i)
                yield ts, img, None, None
            return
        for i, (img, ts) in source:
            if i >= n:
                break
            yield ts, img, None, None
    return gen


def parser() -> argparse.ArgumentParser:
    """The command line of ``main``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--experiment", default=None,
                    help="experiment YAML (svo_analysis/experiments "
                         "format); overrides --dataset/--preset")
    ap.add_argument("--dataset-dir", default=None,
                    help="root of dataset directories ($SVO_DATASET_DIR)")
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "tum", "euroc", "blender"])
    ap.add_argument("--path", default=None, help="dataset directory")
    ap.add_argument("--out", default="svo_run")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--preset", default="fast",
                    choices=["fast", "accurate"])
    ap.add_argument("--grid-size", type=int, default=25)
    ap.add_argument("--cam", default=None,
                    help="fx,fy,cx,cy[,k1,k2,p1,p2]")
    ap.add_argument("--seed-first-frame", action="store_true",
                    default=True,
                    help="seed frame 0 with GT depth when available")
    ap.add_argument("--noise-sigma", type=float, default=0.0,
                    help="Gaussian image noise stddev (benchmark_node's "
                         "dataset_noise_sigma)")
    ap.add_argument("--noise-seed", type=int, default=0)
    ap.add_argument("--trace-depth", action="store_true",
                    help="trace per-feature depth errors vs GT depth "
                         "maps (blender datasets)")
    ap.add_argument("--min-fts", type=int, default=0,
                    help="override quality_min_fts (small images)")
    ap.add_argument("--ply", action="store_true",
                    help="export final map points as PLY")
    ap.add_argument("--device", default="cuda",
                    help="torch device the pipeline runs on")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main():
    args = parser().parse_args()
    if args.experiment:
        run_experiment(args)
    else:
        run(args)


if __name__ == "__main__":
    main()
