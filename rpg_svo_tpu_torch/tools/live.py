"""Live VO entry point — the `vo_node` equivalent (svo_ros/src/vo_node.cpp).

Port of ``rpg_svo_tpu/tools/live.py``: runs the port's ``FrameHandler`` on
a stream of images (a directory of frames, optionally watched for new
files, or the hermetic synthetic camera), prints the rqt-style status line
per frame (rqt_svo/src/rqt_svo/svo_widget.py:85-107), and accepts the
reference's remote-key commands on stdin (vo_node.cpp:119-147):

    s  start/restart tracking        r  reset to paused        q  quit

Usage:
    python -m rpg_svo_tpu_torch.tools.live --source synthetic --frames 120
    python -m rpg_svo_tpu_torch.tools.live --source /path/to/imgs \\
        --cam 315.5,315.5,376,240,752,480 --fps 30 [--watch]

Runs on the card unless ``--cpu`` (or ``--device``) asks for another
device; without a card it raises.  The handler's image shape is the
camera's height and width (the JAX tool keeps the handler's default
752x480 whatever the camera is).  The reference's ROS publications map
to: Info -> stdout status line; pose -> optional TUM-format tracefile
(--traj-out); annotated image -> optional .npy dumps (--viz-dir).
"""

from __future__ import annotations

import argparse
import glob
import os
import select
import sys
import time

import numpy as np


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="live visual odometry (vo_node equivalent)")
    ap.add_argument("--source", default="synthetic",
                    help="'synthetic' or a directory of image files")
    ap.add_argument("--pattern", default="*.png")
    ap.add_argument("--watch", action="store_true",
                    help="keep polling the directory for new frames")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--fps", type=float, default=0.0,
                    help="throttle input rate (0 = as fast as possible)")
    ap.add_argument("--preset", default="fast",
                    choices=["fast", "accurate"])
    ap.add_argument("--grid-size", type=int, default=0)
    ap.add_argument("--cam", default="",
                    help="pinhole intrinsics fx,fy,cx,cy,width,height "
                         "(required for a directory source)")
    ap.add_argument("--cam-yaml", default="",
                    help="camera YAML (cam_* keys, Pinhole or ATAN)")
    ap.add_argument("--traj-out", default="",
                    help="write TUM-format trajectory here")
    ap.add_argument("--viz-dir", default="",
                    help="dump annotated frames (.npy) into this dir")
    ap.add_argument("--paused", action="store_true",
                    help="start paused (send 's' to start)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the same as --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the pipeline runs on")
    return ap.parse_args(argv)


def _poll_key() -> str:
    """Non-blocking single-char stdin poll (vk::UserInputThread)."""
    if not sys.stdin.isatty():
        return ""
    r, _, _ = select.select([sys.stdin], [], [], 0.0)
    if r:
        return sys.stdin.readline().strip()[:1]
    return ""


def main(argv=None):
    args = _parse_args(argv)
    from rpg_svo_tpu_torch import resolve_device, viz
    from rpg_svo_tpu_torch.config import accurate_preset, fast_preset
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    from rpg_svo_tpu_torch.io.trajectory import pose_entry, write_tum

    dev = resolve_device("cpu" if args.cpu else args.device)
    overrides = {}
    if args.grid_size:
        overrides["grid_size"] = args.grid_size
    cfg = (fast_preset(**overrides) if args.preset == "fast"
           else accurate_preset(**overrides))

    # ---- image source ---------------------------------------------------
    if args.source == "synthetic":
        from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset
        ds = SyntheticDataset(n_frames=args.frames, trajectory="circle",
                              radius=0.25, revolutions=0.5, device=dev)
        cam = ds.cam

        def frames():
            for i in range(args.frames):
                yield i / 50.0, ds.frame(i)[0]
    else:
        from rpg_svo_tpu_torch.geometry.cameras import PinholeCamera
        from rpg_svo_tpu_torch.io.datasets import load_image_gray
        if args.cam_yaml:
            # vikit camera_loader path (vo_node.cpp:72-73)
            from rpg_svo_tpu_torch.io.camera_loader import load_camera_yaml
            cam = load_camera_yaml(args.cam_yaml)
        elif args.cam:
            fx, fy, cx, cy, w, h = [float(v) for v in args.cam.split(",")]
            cam = PinholeCamera.make(int(w), int(h), fx, fy, cx, cy)
        else:
            sys.exit("--cam fx,fy,cx,cy,w,h or --cam-yaml is required "
                     "for a directory source")

        def frames():
            seen = set()
            t0 = time.time()
            while True:
                files = sorted(glob.glob(os.path.join(args.source,
                                                      args.pattern)))
                new = [f for f in files if f not in seen]
                if not new and not args.watch:
                    return
                for f in new:
                    seen.add(f)
                    yield time.time() - t0, load_image_gray(f)
                if args.watch and not new:
                    time.sleep(0.01)

    fh = FrameHandler(cam, cfg, img_shape=(int(cam.height), int(cam.width)),
                      device=dev)
    stream = viz.InfoStream()
    traj_entries = []
    if args.viz_dir:
        os.makedirs(args.viz_dir, exist_ok=True)

    paused = args.paused
    period = 1.0 / args.fps if args.fps > 0 else 0.0
    last_t = 0.0
    n = 0
    for ts, img in frames():
        key = _poll_key()
        if key == "q":
            print("quit requested")
            break
        if key == "r":
            fh.reset()
            paused = True
            print("reset -> paused")
            continue
        if key == "s":
            fh.reset()
            paused = False
            print("start")
        if paused:
            continue
        if period:
            now = time.time()
            if now - last_t < period:
                time.sleep(period - (now - last_t))
            last_t = time.time()

        info = fh.add_image(img, timestamp=ts)
        rec = viz.Info.from_frame_info(
            dict(info, frame_id=int(fh.last_frame.frame_id),
                 timestamp=ts,
                 is_keyframe=info.get("result") == "keyframe",
                 stage=fh.stage),
            quality=fh.quality)
        stream.push(rec)
        print(viz.status_line(rec, fps=stream.fps), flush=True)
        n += 1

        if args.traj_out and info.get("result") != "failure":
            traj_entries.append(
                pose_entry(ts, fh.last_frame.T_f_w.inverse()))
        if args.viz_dir:
            ann = viz.draw_features(img, fh.last_frame.feat_px,
                                    fh.last_frame.feat_valid)
            np.save(os.path.join(args.viz_dir,
                                 f"frame_{rec.frame_id:06d}.npy"), ann)

    if args.traj_out and traj_entries:
        write_tum(args.traj_out, traj_entries)
        print(f"wrote {len(traj_entries)} poses to {args.traj_out}")
    print(f"processed {n} frames")


if __name__ == "__main__":
    main()
