"""Shared helpers of the tests that hold rpg_svo_tpu_torch against the JAX
package: state conversion to nested numpy dicts, the small scene both
packages render, and the card check of the CUDA-marked tests."""

from __future__ import annotations

import numpy as np
import pytest
import torch

# the port's CPU tests run small tensors op by op: one intra-op thread is
# as fast, and the suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

# small scene of the port tests: 240x320 keeps the JAX CPU compiles short;
# grid 12 gives 27x20 = 540 cells, more than the 256-cell attempt budget,
# so the reprojector's budgeted selection runs as in the 752x480 bench
SHAPE = (240, 320)
CFG_KW = dict(grid_size=12, max_points=2048, max_kfs_pool=4, max_seeds=128,
              ablate=("kf", "df"))
# the whole step (ablate=()) on the small scene: the bench's epipolar scan
# (32/8 steps, 4 rows), a 128-seed pool updated 96 at a time (the
# compacted path), and a keyframe every 3-4 frames (kfselect 0.08) into a
# 6-slot pool capped at 4 keyframes, so that within 18 frames keyframes
# are inserted, seeds are updated and converge into candidates, and the
# map cap deletes keyframes
FULL_KW = dict(grid_size=12, max_points=2048, max_kfs_pool=6, max_seeds=128,
               max_n_kfs=4, kfselect_mindist=0.08, df_update_k=96,
               epi_max_steps=32, epi_short_steps=8, epi_scan_rows=4)
# the scene of the whole-step tests: twice the angular speed of the
# slice-A scene
FULL_SCENE = dict(n_frames=36, trajectory="circle", radius=0.25,
                  revolutions=0.9, shape=SHAPE)
FULL_FRAMES = 18


def jax_tree(x):
    """A JAX pytree of NamedTuples (and PaddedPyramids) as nested dicts of
    numpy arrays, the layout core/convert.state_from_numpy reads."""
    if hasattr(x, "_asdict"):
        return {k: jax_tree(v) for k, v in x._asdict().items()}
    if hasattr(x, "stack") and hasattr(x, "shapes"):
        return {"stack": np.array(x.stack),
                "shapes": [list(s) for s in x.shapes]}
    return np.array(x)


def to_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def jax_state(tree):
    """The JAX package's VOState from nested dicts of numpy arrays (the
    layout of core/convert.state_to_numpy)."""
    import jax.numpy as jnp
    from rpg_svo_tpu.core import fused as jfused
    from rpg_svo_tpu.core import map as jmap
    from rpg_svo_tpu.ops.pallas_tiles import PaddedPyramid

    def nt(cls, d):
        return cls(**{k: jnp.asarray(d[k]) for k in cls._fields})
    m = tree["m"]
    mapstate = jmap.MapState(nt(jmap.KeyframeStore, m["kf"]),
                             nt(jmap.PointStore, m["pt"]),
                             nt(jmap.SeedStore, m["seed"]),
                             jnp.asarray(m["kf_counter"]))
    pad = PaddedPyramid.from_stack(jnp.asarray(tree["pad"]["stack"]),
                                   tree["pad"]["shapes"])
    return jfused.VOState(m=mapstate, pad=pad, **{
        k: jnp.asarray(tree[k]) for k in jfused.VOState._fields
        if k not in ("m", "pad")})


def run_full(preset: str, n_frames: int = FULL_FRAMES, jax_steps=True):
    """The whole-step scene (JAX renderer), seeded by the port's
    seed_first_frame_with_depth on the CPU (its agreement with
    FrameHandler is tests/test_torch_fused.py's), then n_frames steps of
    the JAX fused step (jax_steps) or of the port's.  Returns a dict with
    the dataset, both configs, the grid (fh.ncx, fh.ncy), the numpy images
    of frames 1..n, the states as JAX VOStates (index i: after frame i)
    and the step outputs, and the port's camera."""
    import types

    import jax.numpy as jnp
    from rpg_svo_tpu import config as jconfig
    from rpg_svo_tpu.core import fused as jfused
    from rpg_svo_tpu.utils.synthetic import SyntheticDataset
    from rpg_svo_tpu_torch import config as tconfig
    from rpg_svo_tpu_torch.core import fused as tfused
    from rpg_svo_tpu_torch.core.convert import state_to_numpy
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    from rpg_svo_tpu_torch.ops.detector import grid_dims
    from rpg_svo_tpu_torch.utils.synthetic import reference_test_camera
    ds = SyntheticDataset(**FULL_SCENE)
    jcfg = getattr(jconfig, f"{preset}_preset")(**FULL_KW)
    tcfg = getattr(tconfig, f"{preset}_preset")(**FULL_KW)
    cam = reference_test_camera(SHAPE[1], SHAPE[0])
    fh = types.SimpleNamespace(
        **dict(zip(("ncx", "ncy"), grid_dims(SHAPE[1], SHAPE[0],
                                             tcfg.grid_size))))
    img0, depth0, T0 = ds.frame(0)
    Tfw = T0.inverse()
    ts = tfused.seed_first_frame_with_depth(
        to_torch(img0), SE3(to_torch(Tfw.R), to_torch(Tfw.t)),
        to_torch(depth0), cam, tcfg, img_shape=SHAPE, device="cpu")
    states = [jax_state(state_to_numpy(ts))]
    outs = []
    imgs = [np.asarray(ds.frame(i)[0]) for i in range(1, n_frames + 1)]
    for img in imgs:
        if jax_steps:
            js, out = jfused.vo_step(states[-1], jnp.asarray(img), ds.cam,
                                     jcfg, fh.ncx, fh.ncy, SHAPE)
        else:
            ts, out = tfused.vo_step(ts, to_torch(img), cam, tcfg, fh.ncx,
                                     fh.ncy, SHAPE)
            js = jax_state(state_to_numpy(ts))
        states.append(js)
        outs.append(out)
    return dict(ds=ds, jcfg=jcfg, tcfg=tcfg, fh=fh, imgs=imgs, T0=T0,
                img0=np.asarray(img0), depth0=np.asarray(depth0),
                states=states, outs=outs, cam=cam)


def close(a, b, name, atol, rtol=None):
    """Integer and bool arrays exactly; floats to atol with rtol = atol/10
    unless given."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, atol=atol,
                                   rtol=atol / 10 if rtol is None else rtol,
                                   err_msg=name)


def need_cuda() -> torch.device:
    """The card for a CUDA-marked test; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the chip")
    return torch.device("cuda")


def jax_frame_tree(fr):
    """A JAX FrameState as the dict core/convert.frame_from_numpy reads."""
    return {k: (float(v) if k == "timestamp" else jax_tree(v))
            for k, v in fr._asdict().items() if k not in ("pyr", "flat")}


def jax_handler_tree(fh):
    """A JAX FrameHandler's state as core/convert.handler_from_numpy reads
    it."""
    ini = fh.initializer
    frame0 = getattr(fh, "_init_frame0", None)
    return {
        "map": jax_tree(fh.map),
        "last_frame": None if fh.last_frame is None
        else jax_frame_tree(fh.last_frame),
        "stage": fh.stage, "quality": fh.quality,
        "num_obs_last": int(fh.num_obs_last), "next_id": int(fh.next_id),
        "init": {"state": None if ini.state is None else jax_tree(ini.state),
                 "ref_pyr": None if ini.ref_pyr is None
                 else [np.array(a) for a in ini.ref_pyr],
                 "frame0": None if frame0 is None
                 else jax_frame_tree(frame0)}}


def jax_reference(n_frames: int = 441, timed_from: int = 41,
                  stride: int = 5, chunk: int = 40) -> dict:
    """The JAX package's figures behind the port's chip limits, on the
    bench scene (752x480, 441-frame circle) with ``bench_cfg("fast")``:

    - ``handler``: FrameHandler from ground-truth depth over frames
      1..n-1 (bench.py::run_preset's start, then the handler itself):
      median and max translation error over frames timed_from..n-1,
      failed frames, keyframe frames;
    - ``bootstrap``: bench.py::run_bootstrap's protocol: add_image from
      frame 0 at ``stride`` until the default stage, then the fused step
      in ``chunk``-frame scans; the Sim3-aligned ATE median over bench's
      window (its warm-up chunk and whole timed chunks) and over all
      frames to the end.

    Run on the CPU: ``JAX_PLATFORMS=cpu python tests/_torch_port.py``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from rpg_svo_tpu.analysis.ate import ate_rmse
    from rpg_svo_tpu.config import Config as JConfig
    from rpg_svo_tpu.core import fused as jfused
    from rpg_svo_tpu.core.pipeline import FrameHandler
    from rpg_svo_tpu.utils.synthetic import SyntheticDataset
    from rpg_svo_tpu_torch.config import bench_cfg
    cfg = JConfig(**dataclasses.asdict(bench_cfg("fast")))
    ds = SyntheticDataset(n_frames=n_frames, trajectory="circle",
                          radius=0.25, revolutions=0.5)
    imgs = [ds.frame(i)[0] for i in range(n_frames)]
    gt = np.stack([np.asarray(ds.poses[i].t) for i in range(n_frames)])
    out = {}

    fh = FrameHandler(ds.cam, cfg)
    img0, depth0, T0 = ds.frame(0)
    fh.set_first_frame_with_depth(img0, T0.inverse(), depth0)
    pos, failed, kfs = [], [], []
    for i in range(1, n_frames):
        info = fh.add_image(imgs[i], i / 50.0)
        pos.append(np.asarray(fh.last_frame.T_f_w.inverse().t))
        failed += [i] if info["result"] == "failure" else []
        kfs += [i] if info.get("is_keyframe") else []
    terr = np.linalg.norm(np.stack(pos) - gt[1:], axis=-1)[timed_from - 1:]
    out["handler"] = {"median_terr_mm": float(np.median(terr)) * 1e3,
                      "max_terr_mm": float(terr.max()) * 1e3,
                      "failed": failed, "keyframes": kfs}

    fh = FrameHandler(ds.cam, cfg)
    fh.add_image(imgs[0], 0.0)
    i, i_boot, inliers = 0, None, None
    while i + stride < n_frames - 1:
        i += stride
        info = fh.add_image(imgs[i], i / 50.0)
        if fh.stage == "default":
            i_boot, inliers = i, info["init_inliers"]
            break
    state = jfused.state_from_handler(fh)
    est = []
    for s in range(i_boot + 1, n_frames, chunk):
        state, o = jfused.vo_scan(state, jnp.stack(imgs[s:s + chunk]),
                                  ds.cam, cfg, fh.ncx, fh.ncy, fh.img_shape)
        est.append(np.asarray(o.t_wc))
    est = np.concatenate(est)
    n_bench = chunk + chunk * ((n_frames - 1 - i_boot - chunk) // chunk)
    ate_b = ate_rmse(gt[i_boot + 1:i_boot + 1 + n_bench], est[:n_bench])
    ate_all = ate_rmse(gt[i_boot + 1:], est)
    out["bootstrap"] = {"frame": i_boot, "inliers": inliers,
                        "bench_window": [i_boot + 1, i_boot + n_bench],
                        "ate_median_mm": ate_b["median"] * 1e3,
                        "ate_median_mm_to_end": ate_all["median"] * 1e3,
                        "scale": ate_b["scale"]}
    out["platform"] = jax.default_backend()
    return out


def jax_camera(model: str):
    """The JAX package's ATAN camera (from chip_smoke.ATAN_YAML, through its
    load_camera_yaml) or Omni camera (chip_smoke.omni_calibration)."""
    import tempfile

    import chip_smoke
    from rpg_svo_tpu.geometry.cameras import OmniCamera
    from rpg_svo_tpu.io.camera_loader import load_camera_yaml
    if model == "omni":
        poly, inv = chip_smoke.omni_calibration()
        return OmniCamera.make(752, 480, poly, inv, 376.0, 240.0)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/camera_atan.yaml"
        with open(path, "w") as f:
            f.write(chip_smoke.ATAN_YAML)
        return load_camera_yaml(path)


def jax_camera_reference(model: str, n_frames: int = 441,
                         timed_from: int = 41) -> dict:
    """The JAX FrameHandler (``bench_cfg("fast")``) from ground-truth depth
    on the bench scene rendered through the ATAN or Omni camera at 752x480,
    frames 1..n-1: median and max translation error over frames
    timed_from..n-1 (over all of them where n <= timed_from), failed
    frames, keyframes, and the first frame that failed."""
    import dataclasses

    import jax
    from rpg_svo_tpu.config import Config as JConfig
    from rpg_svo_tpu.core.pipeline import FrameHandler
    from rpg_svo_tpu.utils.synthetic import SyntheticDataset, render_frame
    from rpg_svo_tpu_torch.config import bench_cfg
    cfg = JConfig(**dataclasses.asdict(bench_cfg("fast")))
    cam = jax_camera(model)
    ds = SyntheticDataset(n_frames=441, trajectory="circle", radius=0.25,
                          revolutions=0.5)
    render = jax.jit(lambda T: render_frame(cam, ds.tex, T, ds.shape))
    gt = np.stack([np.asarray(p.t) for p in ds.poses])
    fh = FrameHandler(cam, cfg)
    img0, depth0 = render(ds.poses[0])
    fh.set_first_frame_with_depth(img0, ds.poses[0].inverse(), depth0)
    pos, failed, kfs = [], [], []
    for i in range(1, n_frames):
        info = fh.add_image(render(ds.poses[i])[0], i / 50.0)
        pos.append(np.asarray(fh.last_frame.T_f_w.inverse().t))
        failed += [i] if info["result"] == "failure" else []
        kfs += [i] if info.get("is_keyframe") else []
    terr = np.linalg.norm(np.stack(pos) - gt[1:n_frames], axis=-1)
    win = terr[timed_from - 1:] if n_frames > timed_from else terr
    return {"camera": model, "frames": [1, n_frames - 1],
            "window": [timed_from if n_frames > timed_from else 1,
                       n_frames - 1],
            "median_terr_mm": float(np.median(win)) * 1e3,
            "max_terr_mm": float(win.max()) * 1e3,
            "failed": failed, "keyframes": kfs,
            "first_failure": failed[0] if failed else None}


def omni_split(n_frames: int = 201, timed_from: int = 41,
               split_m: float = 1e-4, noise: float = 1e-3) -> dict:
    """Where the JAX and the port's FrameHandler (``bench_cfg("fast")``,
    ground-truth depth start) part on the Omni-rendered bench scene, both
    fed the JAX renderer's images, and where each parts from itself when
    those images carry N(0, noise) gray levels of added noise (seed 1):
    the first frame more than split_m apart, the largest gap (mm), and each
    run's median and max translation error over frames timed_from..n-1.
    The port runs on the CPU."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import chip_smoke
    from rpg_svo_tpu.config import Config as JConfig
    from rpg_svo_tpu.core.pipeline import FrameHandler as JFrameHandler
    from rpg_svo_tpu.utils.synthetic import SyntheticDataset, render_frame
    from rpg_svo_tpu_torch.config import bench_cfg
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    from rpg_svo_tpu_torch.geometry.cameras import OmniCamera
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    cfg = bench_cfg("fast")
    jc = jax_camera("omni")
    poly, inv = chip_smoke.omni_calibration()
    tc = OmniCamera.make(752, 480, poly, inv, 376.0, 240.0)
    ds = SyntheticDataset(n_frames=441, trajectory="circle", radius=0.25,
                          revolutions=0.5)
    render = jax.jit(lambda T: render_frame(jc, ds.tex, T, ds.shape))
    frames = [render(ds.poses[i]) for i in range(n_frames)]
    imgs = [np.array(f[0]) for f in frames]
    depth0 = np.array(frames[0][1])
    rng = np.random.default_rng(1)
    noisy = [im + rng.normal(0, noise, im.shape).astype(np.float32)
             for im in imgs]
    gt = np.stack([np.asarray(p.t) for p in ds.poses])[1:n_frames]
    T0 = ds.poses[0].inverse()

    def run_jax(ims):
        fh = JFrameHandler(jc, JConfig(**dataclasses.asdict(cfg)))
        fh.set_first_frame_with_depth(jnp.asarray(ims[0]), T0,
                                      jnp.asarray(depth0))
        out = []
        for i in range(1, n_frames):
            fh.add_image(jnp.asarray(ims[i]), i / 50.0)
            out.append(np.asarray(fh.last_frame.T_f_w.inverse().t))
        return np.stack(out)

    def run_port(ims):
        fh = FrameHandler(tc, cfg, tuple(ds.shape), device="cpu")
        fh.set_first_frame_with_depth(
            torch.from_numpy(ims[0].copy()),
            SE3(torch.from_numpy(np.array(T0.R)),
                torch.from_numpy(np.array(T0.t))),
            torch.from_numpy(depth0.copy()))
        out = []
        for i in range(1, n_frames):
            fh.add_image(torch.from_numpy(ims[i].copy()), i / 50.0)
            out.append(fh.last_frame.T_f_w.inverse().t.numpy())
        return np.stack(out)

    runs = {"jax": run_jax(imgs), "jax_noisy": run_jax(noisy),
            "port": run_port(imgs), "port_noisy": run_port(noisy)}
    out = {"frames": [1, n_frames - 1], "noise": noise, "split_m": split_m}
    for a, b in (("jax", "port"), ("jax", "jax_noisy"),
                 ("port", "port_noisy")):
        gap = np.abs(runs[a] - runs[b]).max(axis=1)
        out[f"{a}_vs_{b}"] = {
            "first_split": next((i for i, g in enumerate(gap, 1)
                                 if g > split_m), None),
            "max_gap_mm": float(gap.max()) * 1e3}
    for k, pos in runs.items():
        terr = np.linalg.norm(pos - gt, axis=-1)[timed_from - 1:]
        out[k] = {"median_terr_mm": float(np.median(terr)) * 1e3,
                  "max_terr_mm": float(terr.max()) * 1e3}
    return out


def write_driver_trees(root) -> dict:
    """The bench scene rendered by the port on the CPU and written as
    chip_smoke.py's phases 15 and 16 write it: the blender tree (all 441
    frames, depth maps of frame 0 and every 40th) and the EuRoC tree (every
    5th frame as PGM).  Returns the two directories."""
    import pathlib

    import chip_smoke
    from rpg_svo_tpu_torch.geometry.se3 import rot_to_quat
    from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset
    ds = SyntheticDataset(n_frames=441, trajectory="circle", radius=0.25,
                          revolutions=0.5, device="cpu")
    imgs, depths = [], {}
    for i in range(len(ds)):
        img, depth, _ = ds.frame(i)
        imgs.append(chip_smoke.to_u8(img.numpy()))
        if i % chip_smoke.DEPTH_EVERY == 0:
            depths[i] = depth.numpy()
    t = np.stack([p.t.numpy() for p in ds.poses])
    q = np.stack([rot_to_quat(p.R).numpy() for p in ds.poses])
    root = pathlib.Path(root)
    chip_smoke.write_blender(root / "blender", imgs, t, q, depths)
    sel = list(range(0, len(ds), chip_smoke.EUROC_STRIDE))
    chip_smoke.write_euroc(root / "euroc", sel, [imgs[i] for i in sel], t, q)
    return {"blender": str(root / "blender"), "euroc": str(root / "euroc")}


def driver_args(dataset: str, path: str, out: str, **kw):
    """The arguments chip_smoke.py's driver phases pass (the CLI's
    defaults otherwise)."""
    import argparse
    import chip_smoke
    base = dict(experiment=None, dataset_dir=None, dataset=dataset,
                path=path, out=out, frames=441, preset="fast", grid_size=25,
                cam=",".join(str(v) for v in chip_smoke.CAM_PINHOLE),
                seed_first_frame=True, noise_sigma=0.0, noise_seed=0,
                trace_depth=False, min_fts=0, ply=False, verbose=False)
    if dataset == "blender":
        base.update(noise_sigma=1.0, trace_depth=True, ply=True)
    base.update(kw)
    return argparse.Namespace(**base)


def jax_driver_reference(root) -> dict:
    """The JAX driver (rpg_svo_tpu.tools.benchmark.run) on the trees of
    write_driver_trees: the blender protocol and the EuRoC bootstrap.
    The JAX driver's file-dataset iterator names jnp without importing it
    (rpg_svo_tpu/tools/benchmark.py:316,321); the module gets it here."""
    import pathlib

    import jax.numpy as jnp
    import rpg_svo_tpu.tools.benchmark as jb
    jb.jnp = jnp
    trees = write_driver_trees(root)
    out = {}
    for name in ("blender", "euroc"):
        rep = jb.run(driver_args(name, trees[name],
                                 str(pathlib.Path(root) / f"out_{name}")))
        out[name] = {k: rep[k] for k in ("frames", "ate", "rpe_delta1",
                                         "depth_error") if k in rep}
    return out


def jax_live_reference(root) -> dict:
    """The JAX live tool (rpg_svo_tpu.tools.live.main) on the CPU with
    chip_smoke.py's live arguments: its synthetic source is the bench
    scene.  Returns chip_smoke.live_figures of its status lines and TUM
    file, and its seconds."""
    import contextlib
    import io
    import pathlib
    import time

    import chip_smoke
    from rpg_svo_tpu.tools import live
    from rpg_svo_tpu.utils.synthetic import SyntheticDataset
    tum = pathlib.Path(root) / "live_tum.txt"
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        live.main(chip_smoke.live_args(tum) + ["--cpu"])
    seconds = time.perf_counter() - t0
    ds = SyntheticDataset(n_frames=chip_smoke.N_FRAMES, trajectory="circle",
                          radius=0.25, revolutions=0.5)
    gt = np.stack([np.asarray(p.t) for p in ds.poses])
    return dict(chip_smoke.live_figures(out.getvalue(), tum, gt),
                seconds=seconds)


if __name__ == "__main__":
    import json
    import sys
    import tempfile
    sys.path.insert(0, str(__import__("pathlib").Path(__file__)
                           .resolve().parent.parent))
    parts = sys.argv[1:] or ["handler", "atan", "omni", "driver",
                             "omni_split", "live"]
    res = {}
    if "handler" in parts:
        res.update(jax_reference())
    if "atan" in parts:
        res["atan"] = jax_camera_reference("atan", n_frames=121)
    if "omni" in parts:
        res["omni"] = jax_camera_reference("omni", n_frames=121)
    if "omni_split" in parts:
        res["omni_split"] = omni_split()
    if "driver" in parts:
        with tempfile.TemporaryDirectory() as d:
            res["driver"] = jax_driver_reference(d)
    if "live" in parts:
        with tempfile.TemporaryDirectory() as d:
            res["live"] = jax_live_reference(d)
    print(json.dumps(res))
