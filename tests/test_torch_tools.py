"""The port's tools and the rest of analysis/ against the JAX package on
the CPU: timing, comparison, hand-eye, smoothing and the depth precision
plot on the same numpy inputs (tests/test_analysis_extras.py and
tests/test_io_analysis.py drive the reference the same way), the
dashboard, and the live entry point (tools/live.py, the vo_node
equivalent).

The live tools run on the same directory of rendered PNGs at 752x480 with
the same scripted stdin keys (s, r, q through ``_poll_key``).  Tolerances:
analysis numbers to 1e-12 (the same float64 numpy code); rendered
dashboards pixel for pixel; live status lines equal but for the fps field
(a wall-clock rate); TUM poses to 1e-4 m (JAX and the port track the same
images to ~4e-5 m); the .npy overlays equal but for 1e-4 of their pixels
(a feature box drawn one pixel over).  The JAX live tool keeps the
handler's default 752x480 whatever the camera: on 320x240 frames it
raises, where the port's tool takes its shape from the camera.
"""

import io
import os
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from rpg_svo_tpu.analysis import compare as jcompare
from rpg_svo_tpu.analysis import depth as jdepth
from rpg_svo_tpu.analysis import hand_eye as jhe
from rpg_svo_tpu.analysis import smoothing as jsmooth
from rpg_svo_tpu.analysis import timing as jtiming
from rpg_svo_tpu.tools import dashboard as jdash
from rpg_svo_tpu.tools import live as jlive
from rpg_svo_tpu_torch import viz
from rpg_svo_tpu_torch.analysis import compare as tcompare
from rpg_svo_tpu_torch.analysis import depth as tdepth
from rpg_svo_tpu_torch.analysis import hand_eye as the
from rpg_svo_tpu_torch.analysis import smoothing as tsmooth
from rpg_svo_tpu_torch.analysis import timing as ttiming
from rpg_svo_tpu_torch.io.trace import TraceWriter
from rpg_svo_tpu_torch.tools import dashboard as tdash
from rpg_svo_tpu_torch.tools import live as tlive
from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset

CAM_752 = "315.5,315.5,376,240,752,480"
CAM_320 = "315.5,315.5,160,120,320,240"
# a feature within float noise of a pixel edge draws its 5x5 box one pixel
# over: up to 1e-4 of an overlay's pixels may differ
OVERLAY_TOL = 1e-4


def _same(a, b, tol=1e-12):
    """Nested dicts/lists of numbers and arrays equal to tol."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k], tol)
    elif isinstance(a, (str, type(None))):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   atol=tol, rtol=tol)


def _trace(tmp_path, name, n=30, fail_at=7):
    tw = TraceWriter(str(tmp_path), name)
    rng = np.random.default_rng(0)
    for i in range(n):
        tw.log_frame({"timestamp": 0.02 * i,
                      "proc_time": 0.004 + 0.001 * rng.random(),
                      "sparse_img_align": 0.001, "reproject": 0.0015,
                      "pyramid_creation": 0.0004,
                      "pose_optimizer": 0.0005, "point_optimizer": 0.0002,
                      "feature_align": 0.001, "reproject_kfs": 0.0003,
                      "reproject_candidates": 0.0002,
                      "repr_n_mps": 100, "repr_n_new_references": 80 + i,
                      "img_align_n_tracked": 90 + i, "n_seeds": 40 + i,
                      "result": "failure" if i == fail_at
                      else "no_keyframe"})
    return tw.flush()


def test_timing_matches_jax(tmp_path):
    """load_trace, timing_stats and log_stats equal; plot_timing writes
    the same three plots (analyse_timing.py parity)."""
    path = _trace(tmp_path, "svo")
    tt, jt = ttiming.load_trace(path), jtiming.load_trace(path)
    _same(tt, jt)
    _same(ttiming.timing_stats(tt), jtiming.timing_stats(jt))
    _same(ttiming.log_stats(tt), jtiming.log_stats(jt))
    for mod, sub in ((ttiming, "port"), (jtiming, "jax")):
        os.makedirs(tmp_path / sub)
        written = mod.plot_timing(tt, str(tmp_path / sub))
        assert [os.path.basename(p) for p in written] == [
            "timing.pdf", "timing_boxplot.pdf", "timing_reprojection.pdf"]
        assert all(os.path.getsize(p) > 500 for p in written)


def _rot(ax, a):
    c, s = np.cos(a), np.sin(a)
    i, j = [(1, 2), (0, 2), (0, 1)][ax]
    R = np.eye(3)
    R[i, i] = R[j, j] = c
    R[i, j], R[j, i] = -s, s
    return R


def test_hand_eye_matches_jax():
    """A trajectory pair related by a known hand-eye transform
    (tests/test_analysis_extras.py), calibrated by both packages."""
    rng = np.random.default_rng(1)
    R_he, b_he = _rot(2, 0.4) @ _rot(0, -0.2), np.array([0.05, -0.02, 0.1])
    n = 120
    q_gt, p_gt, q_es, p_es = (np.zeros((n, 4)), np.zeros((n, 3)),
                              np.zeros((n, 4)), np.zeros((n, 3)))
    for i in range(n):
        Rb = _rot(2, 0.05 * i) @ _rot(0, 0.3 * np.sin(0.07 * i))
        tb = np.array([np.cos(0.05 * i), np.sin(0.05 * i), 0.1 * i / n])
        q_gt[i], p_gt[i] = jhe._rot_to_quat(Rb), tb
        q_es[i], p_es[i] = jhe._rot_to_quat(Rb @ R_he), Rb @ b_he + tb
    idx = rng.integers(0, n - 20, size=60)
    tR, tb_ = the.hand_eye_calib(q_gt, q_es, p_gt, p_es, idx, delta=15)
    jR, jb = jhe.hand_eye_calib(q_gt, q_es, p_gt, p_es, idx, delta=15)
    _same(tR, jR)
    _same(tb_, jb)
    err = the.hand_eye_residuals(q_gt, q_es, p_gt, p_es, tR, tb_, delta=15)
    _same(err, jhe.hand_eye_residuals(q_gt, q_es, p_gt, p_es, jR, jb,
                                      delta=15))
    assert np.median(err) < 1e-6


def test_smoothing_and_dataset_stats_match_jax():
    n = 400
    rng = np.random.default_rng(2)
    t = np.arange(n) / 200.0
    rpy = np.stack([0.3 * np.sin(2 * np.pi * t), 0.2 * np.cos(np.pi * t),
                    0.1 * t], -1) + 0.05 * rng.normal(size=(n, 3))
    data = np.zeros((n, 8))
    data[:, 0] = t
    data[:, 1:4] = np.cumsum(rng.normal(scale=0.01, size=(n, 3)), 0)
    data[:, 4:8] = jsmooth._rpy_to_quat(rpy)
    _same(tsmooth.smooth_groundtruth(data, f_cut=10.0),
          jsmooth.smooth_groundtruth(data, f_cut=10.0))
    _same(tsmooth.dataset_stats(data, stepsize=3),
          jsmooth.dataset_stats(data, stepsize=3))


def test_compare_and_plots_match_jax(tmp_path):
    """compare_experiments / error_curve / load_tum on two experiment
    directories; plot_comparison, plot_markers and plot_precision write
    their PDFs."""
    n = 60
    gt = np.zeros((n, 8))
    gt[:, 0] = np.arange(n) * 0.1
    gt[:, 1] = np.linspace(0, 3, n)
    gt[:, 7] = 1.0
    dirs = []
    for j, drift in enumerate([0.0, 0.02]):
        d = tmp_path / f"exp{j}"
        os.makedirs(d)
        est = gt.copy()
        est[:, 2] += drift * np.sin(np.linspace(0, 6 * np.pi, n))
        np.savetxt(d / "groundtruth.txt", gt)
        np.savetxt(d / "traj_estimate.txt", est)
        dirs.append(str(d))
    tres = tcompare.compare_experiments(dirs)
    _same(tres, jcompare.compare_experiments(dirs))
    assert tres["exp1"]["trans_error_rmse"] > 1e-6
    _same(tcompare.load_tum(dirs[1] + "/traj_estimate.txt"),
          jcompare.load_tum(dirs[1] + "/traj_estimate.txt"))
    rng = np.random.default_rng(3)
    markers = [viz.Markers(
        cam_pos=rng.normal(size=3), cam_R_wc=np.eye(3), trajectory_id=i,
        kf_ids=np.arange(3), kf_pos=rng.normal(size=(3, 3)),
        kf_R_wc=np.tile(np.eye(3), (3, 1, 1)), point_ids=np.arange(50),
        point_pos=rng.normal(size=(50, 3)), deleted_ids=np.zeros(0, int))
        for i in range(5)]
    errors = np.abs(rng.normal(scale=0.01, size=500))
    for mod, dm, sub in ((tcompare, tdepth, "port"),
                         (jcompare, jdepth, "jax")):
        out = tmp_path / sub
        os.makedirs(out)
        mod.plot_comparison(tres, str(out / "cmp.pdf"))
        mod.plot_markers(markers, str(out / "markers.pdf"))
        dm.plot_precision(errors, str(out / "precision.pdf"))
        for f in ("cmp.pdf", "markers.pdf", "precision.pdf"):
            assert (out / f).stat().st_size > 500, (sub, f)


def test_dashboard_matches_jax(tmp_path, monkeypatch, capsys):
    """render_dashboard draws the same pixels as the JAX dashboard; main
    renders once, and --live re-reads and re-renders until stopped."""
    import matplotlib.image as mpimg
    path = _trace(tmp_path, "dash", n=20)
    tr = ttiming.load_trace(path)
    t_png = tdash.render_dashboard(tr, str(tmp_path / "port.png"))
    j_png = jdash.render_dashboard(tr, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(mpimg.imread(t_png), mpimg.imread(j_png))

    class Stop(Exception):
        pass

    for mod in (tdash, jdash):
        calls = []

        def sleep(_s, calls=calls):
            calls.append(_s)
            if len(calls) == 2:
                raise Stop
        monkeypatch.setattr(mod.time, "sleep", sleep)
        out = str(tmp_path / f"{mod.__name__.split('.')[0]}.png")
        mod.main([path, "-o", out])
        with pytest.raises(Stop):
            mod.main([path, "-o", out, "--live", "--interval", "0.5"])
        assert calls == [0.5, 0.5]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and all(ln.startswith("rendered ") for ln in lines)


# --- the live entry point ---------------------------------------------------
def _write_frames(root, n, revolutions, shape):
    """A circle of the bench scene at n frames per `revolutions`, rendered
    by the port on the CPU and written as 8-bit PNGs."""
    os.makedirs(root, exist_ok=True)
    ds = SyntheticDataset(n_frames=n, trajectory="circle", radius=0.25,
                          revolutions=revolutions, shape=shape, device="cpu")
    for i in range(n):
        chip_smoke.write_png(os.path.join(root, f"frame_{i:04d}.png"),
                             chip_smoke.to_u8(ds.frame(i)[0].numpy()))
    return str(root)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """The JAX tool points JAX's compilation cache at $JAX_CACHE_DIR: a
    directory of this module, and the process's setting back after it."""
    old = jax.config.jax_compilation_cache_dir
    os.environ["JAX_CACHE_DIR"] = str(tmp_path_factory.mktemp("jax_cache"))
    yield
    del os.environ["JAX_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", old)


# keys polled before each frame: track from frame 0 (bootstrap at frame
# 8), reset at 15 (paused through 16), start again at 17, quit at 20
KEYS = {15: "r", 17: "s", 20: "q"}


def _run_live(mod, argv, monkeypatch):
    polls = iter(range(1000))
    monkeypatch.setattr(mod, "_poll_key", lambda: KEYS.get(next(polls), ""))
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main(argv)
    return out.getvalue().splitlines()


def _no_fps(lines):
    return [re.sub(r"\s+(-|[0-9.]+ fps)\s+", " ", ln) for ln in lines]


def test_live_matches_jax(tmp_path, monkeypatch, jax_cache):
    """Both tools on 21 frames at 752x480 with the keys above: the same
    status lines (bootstrap, tracking, keyframes, reset, restart, quit),
    TUM poses and feature overlays."""
    src = _write_frames(tmp_path / "frames", 21, 0.5, (480, 752))
    outs = {}
    for name, mod in (("port", tlive), ("jax", jlive)):
        d = tmp_path / name
        outs[name] = (_run_live(mod, [
            "--source", src, "--cam", CAM_752, "--cpu",
            "--traj-out", str(d / "traj.txt"), "--viz-dir", str(d / "viz")],
            monkeypatch), d)
    (tl, td), (jl, jd) = outs["port"], outs["jax"]
    assert _no_fps(tl)[:-2] == _no_fps(jl)[:-2]
    assert [ln.replace(str(td), "") for ln in tl[-2:]] \
        == [ln.replace(str(jd), "") for ln in jl[-2:]]
    assert any("[default] frame     8" in ln for ln in tl)
    assert "reset -> paused" in tl and "start" in tl \
        and "quit requested" in tl and tl[-1] == "processed 18 frames"
    tt, jt = np.loadtxt(td / "traj.txt"), np.loadtxt(jd / "traj.txt")
    assert tt.shape == jt.shape == (18, 8)
    np.testing.assert_allclose(tt[:, 1:], jt[:, 1:], atol=1e-4)
    names = sorted(os.listdir(td / "viz"))
    assert names == sorted(os.listdir(jd / "viz")) and len(names) == 18
    for f in names:
        a, b = np.load(td / "viz" / f), np.load(jd / "viz" / f)
        assert a.shape == b.shape == (480, 752)
        assert (a != b).mean() <= OVERLAY_TOL, f


def test_live_takes_the_image_shape_from_the_camera(tmp_path, monkeypatch,
                                                    jax_cache):
    """320x240 frames: the port's tool bootstraps and tracks without a
    failure; the JAX tool, whose handler keeps 752x480, raises on the
    first frame (its detector grid has 416 cells, the image 88)."""
    src = _write_frames(tmp_path / "frames", 16, 1.3, (240, 320))
    argv = ["--source", src, "--cam", CAM_320, "--grid-size", "15",
            "--cpu", "--traj-out", str(tmp_path / "traj.txt")]
    monkeypatch.setattr(tlive, "_poll_key", lambda: "")
    out = io.StringIO()
    with redirect_stdout(out):
        tlive.main(argv)
    lines = out.getvalue().splitlines()
    stages = [ln[1:8].strip() for ln in lines if ln.startswith("[")]
    boot = stages.index("default")
    assert 0 < boot < 12 and set(stages[boot:]) == {"default"}
    assert np.loadtxt(tmp_path / "traj.txt").shape == (16, 8)
    monkeypatch.setattr(jlive, "_poll_key", lambda: "")
    with redirect_stdout(io.StringIO()), pytest.raises(TypeError):
        jlive.main(argv)


def test_live_runs_on_the_card_unless_asked(monkeypatch):
    """Without --cpu or --device the tool asks for cuda: with no card it
    raises rather than fall back to the CPU; --device cpu and the
    synthetic source run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlive.main(["--source", "synthetic", "--frames", "2"])
    monkeypatch.setattr(tlive, "_poll_key", lambda: "")
    out = io.StringIO()
    with redirect_stdout(out):
        tlive.main(["--source", "synthetic", "--frames", "2",
                    "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert [ln[9:21] for ln in lines[:2]] == [" frame     0",
                                              " frame     1"]
    assert lines[-1] == "processed 2 frames"
