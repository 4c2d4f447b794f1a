"""The port's camera models, file I/O, analysis, visualisation records,
checkpoints and surface scene against the JAX package on the CPU.

Cameras: ATAN and Omni world2cam / cam2world / project_unitplane /
is_in_frame / fx on 1,000 seeded points and pixels (rtol 1e-5, pixels
with an absolute floor of 1e-5 of the image width), with ATAN's s < 1e-8
and ru < 1e-8 branches and an Omni affine stretch.  Files: the camera
YAML and ocam loaders, the TUM / EuRoC / blender readers on trees written
to tmp_path, the TUM trajectory, the trace CSV and PLY bytes, the
evaluation (to 1e-9).  The handler: FrameHandler from ground-truth depth
on the ATAN-rendered small scene of tests/_torch_port.py and on the
Omni-rendered bench scene, port against JAX per frame (t_wc within 1e-4
m), and checkpoints carried both ways
between the packages (exact)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rpg_svo_tpu import config as jconfig
from rpg_svo_tpu.analysis import ate as jate
from rpg_svo_tpu.analysis import depth as jdepth
from rpg_svo_tpu.analysis import rpe as jrpe
from rpg_svo_tpu.core import checkpoint as jckpt
from rpg_svo_tpu.core import map_debug as jmap_debug
from rpg_svo_tpu.core.pipeline import FrameHandler as JFrameHandler
from rpg_svo_tpu.geometry import cameras as jcam
from rpg_svo_tpu.geometry import se3 as jse3
from rpg_svo_tpu.io import camera_loader as jloader
from rpg_svo_tpu.io import datasets as jdatasets
from rpg_svo_tpu.io import experiment as jexp
from rpg_svo_tpu.io import ply as jply
from rpg_svo_tpu.io import trace as jtrace
from rpg_svo_tpu.io import trajectory as jtraj
from rpg_svo_tpu.utils import synthetic as jsyn
from rpg_svo_tpu import viz as jviz
from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch import viz as tviz
from rpg_svo_tpu_torch.analysis import ate as tate
from rpg_svo_tpu_torch.analysis import depth as tdepth
from rpg_svo_tpu_torch.analysis import rpe as trpe
from rpg_svo_tpu_torch.core import checkpoint as tckpt
from rpg_svo_tpu_torch.core import map_debug as tmap_debug
from rpg_svo_tpu_torch.core.convert import (
    handler_from_numpy, handler_to_numpy, map_from_numpy)
from rpg_svo_tpu_torch.core.pipeline import FrameHandler
from rpg_svo_tpu_torch.geometry import cameras as tcam
from rpg_svo_tpu_torch.geometry import se3 as tse3
from rpg_svo_tpu_torch.io import camera_loader as tloader
from rpg_svo_tpu_torch.io import datasets as tdatasets
from rpg_svo_tpu_torch.io import experiment as texp
from rpg_svo_tpu_torch.io import ply as tply
from rpg_svo_tpu_torch.io import trace as ttrace
from rpg_svo_tpu_torch.io import trajectory as ttraj
from rpg_svo_tpu_torch.native import loader as tnative
from rpg_svo_tpu_torch.utils import synthetic as tsyn

from _torch_port import FULL_KW, FULL_SCENE, SHAPE, close, jax_handler_tree

RTOL = 1e-5
N_FRAMES = 10
ATAN = (0.511496, 0.802603, 0.530199, 0.496011, 0.934479)


def T(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _omni(mod, w=752, h=480, stretch=(1.02, 0.01, -0.02)):
    poly, inv = chip_smoke.omni_calibration()
    return mod.OmniCamera.make(w, h, poly, inv, w / 2.0, h / 2.0, *stretch)


CAMERAS = {
    "atan": lambda m: m.ATANCamera.make(752, 480, *ATAN),
    "atan_s0": lambda m: m.ATANCamera.make(752, 480, *ATAN[:4], 0.0),
    "omni": lambda m: _omni(m, stretch=(1.0, 0.0, 0.0)),
    "omni_stretched": _omni,
}


def _pixels_and_points(seed=0, n=1000):
    rng = np.random.default_rng(seed)
    px = (rng.uniform(0, 1, (n, 2)) * [752.0, 480.0]).astype(np.float32)
    xyz = np.concatenate([rng.normal(0, 1, (n, 2)),
                          rng.uniform(0.5, 3, (n, 1))], 1).astype(np.float32)
    # the ru < 1e-8 / rd < 1e-8 branches: the principal point, the axis
    px[0] = [0.530199 * 752 - 0.5, 0.496011 * 480 - 0.5]
    xyz[0] = [0.0, 0.0, 2.0]
    return px, xyz


def _px_close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=RTOL * 752, err_msg=name)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_matches_jax(name):
    j, t = CAMERAS[name](jcam), CAMERAS[name](tcam)
    px, xyz = _pixels_and_points()
    np.testing.assert_allclose(t.cam2world(T(px)).numpy(),
                               np.asarray(j.cam2world(jnp.asarray(px))),
                               rtol=RTOL, atol=1e-6)
    _px_close(t.world2cam(T(xyz)), j.world2cam(jnp.asarray(xyz)), "w2c")
    uv = xyz[:, :2] / xyz[:, 2:]
    _px_close(t.project_unitplane(T(uv)),
              j.project_unitplane(jnp.asarray(uv)), "unitplane")
    assert t.fx == pytest.approx(float(j.fx), rel=RTOL)
    assert t.error_multiplier2 == pytest.approx(float(j.error_multiplier2),
                                                rel=RTOL)
    for level, boundary in ((0, 0.0), (1, 4.0), (2, 8.0)):
        pts = np.concatenate([px, [[-1, 5], [751.9, 479.9], [752, 100]]]) \
            .astype(np.float32) / 2 ** level
        np.testing.assert_array_equal(
            t.is_in_frame(T(pts), boundary, level).numpy(),
            np.asarray(j.is_in_frame(jnp.asarray(pts), boundary, level)))
    assert (t.width, t.height) == (752.0, 480.0)


def test_atan_without_distortion_is_pinhole():
    """s < 1e-8: the distortion factors are exactly 1."""
    t = CAMERAS["atan_s0"](tcam)
    px, xyz = _pixels_and_points()
    pin = tcam.PinholeCamera.make(752, 480, t.fx, t.fy, t.cx, t.cy)
    np.testing.assert_array_equal(t.world2cam(T(xyz)).numpy(),
                                  pin.world2cam(T(xyz)).numpy())


def test_omni_fx_is_the_inverse_polynomials_derivative_on_the_axis():
    t = CAMERAS["omni"](tcam)
    eps = 1e-3
    p = t.world2cam(torch.tensor([[0.0, 0.0, 1.0], [eps, 0.0, 1.0]],
                                 dtype=torch.float64))
    fx_emp = float(abs(p[1, 0] - p[0, 0])) / eps
    assert t.fx == pytest.approx(fx_emp, rel=1e-2)
    assert abs(t.inv_poly[1]) < 0.5 * t.fx or abs(t.inv_poly[1]) > 2 * t.fx
    assert len(t.poly) == 5 and len(t.inv_poly) == tcam.INV_POLY_LEN


def test_se3_quaternions_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(500, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = tse3.quat_to_rot(T(q)).numpy()
    np.testing.assert_allclose(R, np.asarray(jse3.quat_to_rot(jnp.asarray(q))),
                               atol=1e-6)
    # every pivot branch: rotations by pi about each axis, and near identity
    R = np.concatenate([R, np.diag([1.0, -1, -1])[None],
                        np.diag([-1.0, 1, -1])[None],
                        np.diag([-1.0, -1, 1])[None]]).astype(np.float32)
    np.testing.assert_allclose(tse3.rot_to_quat(T(R)).numpy(),
                               np.asarray(jse3.rot_to_quat(jnp.asarray(R))),
                               atol=1e-6)
    w = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tse3.hat(T(w)).numpy(),
                                  np.asarray(jse3.hat(jnp.asarray(w))))
    xi = rng.normal(size=(4, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.SE3.exp(T(xi)).adjoint().numpy(),
        np.asarray(jse3.SE3.exp(jnp.asarray(xi)).adjoint()), atol=1e-5)


# -- loaders ----------------------------------------------------------------

OCAM_CALIB = """#polynomial coefficients for the DIRECT mapping function
5 -2.017438e+02 0.000000e+00 1.065216e-03 -3.101391e-07 1.018214e-09

#polynomial coefficients for the inverse mapping function
10 311.5 182.1 5.9 21.3 9.1 -1.2 2.7 3.3 0.8 0.1

#center: "row" and "column", starting from 0 (C convention)
239.5 375.5

#affine parameters "c", "d", "e"
1.0007 0.0012 -0.0009

#image size: "height" and "width"
480 752
"""


def _fields_close(t, j):
    for k in t._fields:
        np.testing.assert_allclose(np.asarray(getattr(t, k), np.float64),
                                   np.asarray(getattr(j, k), np.float64),
                                   rtol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind", ["pinhole", "atan", "ocam_file",
                                  "ocam_keys"])
def test_camera_yaml_matches_jax(tmp_path, kind):
    from test_camera_loader import ATAN_YAML, PINHOLE_YAML
    (tmp_path / "calib_results.txt").write_text(OCAM_CALIB)
    text = {"pinhole": PINHOLE_YAML, "atan": ATAN_YAML,
            "ocam_file": "cam_model: Ocam\ncam_calib_file: calib_results.txt\n",
            "ocam_keys": "cam_model: Ocam\ncam_width: 640\ncam_height: 480\n"
                         "cam_poly: -180.0 0.0 0.0011\n"
                         "cam_inv_poly: 250.1 120.3 8.2 1.1\n"
                         "cam_xc: 320.5\ncam_yc: 240.5\ncam_c: 0.999 # c\n"
                         "cam_d: 0.001\n"}[kind]
    path = tmp_path / "camera.yaml"
    path.write_text(text)
    t, j = tloader.load_camera_yaml(str(path)), \
        jloader.load_camera_yaml(str(path))
    assert type(t).__name__ == type(j).__name__
    _fields_close(t, j)
    assert tloader._parse_flat_yaml(str(path)) == \
        jloader._parse_flat_yaml(str(path))
    if kind == "ocam_file":
        _fields_close(tcam.load_ocam_calib(str(tmp_path / "calib_results.txt")),
                      jcam.load_ocam_calib(str(tmp_path / "calib_results.txt")))


# -- dataset readers ----------------------------------------------------------

def _scene(n=4, shape=(48, 64)):
    ds = tsyn.SyntheticDataset(n_frames=n, trajectory="circle", radius=0.25,
                               revolutions=0.5, shape=shape, device="cpu")
    imgs, depths = [], {}
    for i in range(n):
        img, depth, _ = ds.frame(i)
        imgs.append(chip_smoke.to_u8(img.numpy()))
        depths[i] = depth.numpy()
    t = np.stack([p.t.numpy() for p in ds.poses])
    q = np.stack([tse3.rot_to_quat(p.R).numpy() for p in ds.poses])
    return imgs, depths, t, q


def test_blender_reader_matches_jax(tmp_path):
    imgs, depths, t, q = _scene()
    chip_smoke.write_blender(tmp_path, imgs, t, q, {0: depths[0], 2: depths[2]})
    tb, jb = tdatasets.BlenderDataset(str(tmp_path)), \
        jdatasets.BlenderDataset(str(tmp_path))
    assert len(tb) == len(jb) == 4
    for i in range(4):
        ti, tT, tn = tb.frame(i)
        ji, jT, jn = jb.frame(i)
        assert tn == jn and isinstance(ti, np.ndarray)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(ti, imgs[i])
        np.testing.assert_allclose(tT.R.numpy(), np.asarray(jT.R), atol=1e-7)
        np.testing.assert_array_equal(tT.t.numpy(), np.asarray(jT.t))
        td, jd = tb.depth(i, (48, 64)), jb.depth(i, (48, 64))
        assert (td is None) == (jd is None) == (i not in (0, 2))
        if td is not None:
            np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("image_format", ["pgm", "png"])
def test_tum_reader_matches_jax(tmp_path, image_format):
    imgs, _, t, q = _scene()
    (tmp_path / "rgb").mkdir()
    lines, gt = ["# timestamp filename"], ["# timestamp tx ty tz qx qy qz qw"]
    for i, img in enumerate(imgs):
        name = f"rgb/{i:04d}.{image_format}"
        getattr(chip_smoke, f"write_{image_format}")(tmp_path / name, img)
        lines.append(f"{100 + i * 0.033:.6f} {name}")
        gt.append(f"{100 + i * 0.033:.6f} " + " ".join(
            repr(float(v)) for v in (*t[i], *q[i])))
    (tmp_path / "rgb.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    td, jd = tdatasets.TUMDataset(str(tmp_path)), \
        jdatasets.TUMDataset(str(tmp_path))
    assert len(td) == len(jd) == 4
    for i in range(4):
        (ti, tts), (ji, jts) = td.frame(i), jd.frame(i)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(ti, imgs[i])
        assert tts == jts == td.timestamp(i)
        assert td.image_path(i) == jd.image_path(i)
    for a, b in zip(td.gt, jd.gt):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(td.gt[1], t)


def _euroc(tmp_path):
    imgs, _, t, q = _scene(n=6)
    chip_smoke.write_euroc(tmp_path, [0, 2, 4], [imgs[0], imgs[2], imgs[4]],
                           t, q)
    return imgs


def test_euroc_reader_matches_jax(tmp_path):
    imgs = _euroc(tmp_path)
    td, jd = tdatasets.EuRoCDataset(str(tmp_path)), \
        jdatasets.EuRoCDataset(str(tmp_path))
    assert len(td) == len(jd) == 3
    for k, i in enumerate((0, 2, 4)):
        (ti, tts), (ji, jts) = td.frame(k), jd.frame(k)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(ti, imgs[i])
        assert tts == jts == pytest.approx(i / 50.0)
    for a, b in zip(td.gt, jd.gt):
        np.testing.assert_array_equal(a, b)
    assert td.gt[0].shape == (6,)


@pytest.mark.parametrize("source", ["native", "thread"])
def test_prefetching_sources_match_serial_decoding(tmp_path, source):
    imgs = _euroc(tmp_path)
    ds = tdatasets.EuRoCDataset(str(tmp_path))
    src = tdatasets.NativePrefetchingSource(ds, n_ahead=2) \
        if source == "native" else tdatasets.PrefetchingSource(ds, n_ahead=2)
    got = list(src)
    src.close()
    assert [i for i, _ in got] == [0, 1, 2]
    for (i, (img, ts)), want in zip(got, (0, 2, 4)):
        np.testing.assert_array_equal(img, imgs[want])
        assert ts == ds.timestamp(i)


def test_native_loader_builds_from_the_ports_source(tmp_path):
    lib = tnative.build()
    assert lib is not None and tnative.has_png()
    assert lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert lib.name.startswith("libsvoloader-")
    img = (np.arange(35, dtype=np.uint8) * 7).reshape(5, 7)
    chip_smoke.write_pgm(tmp_path / "a.pgm", img)
    np.testing.assert_array_equal(tnative.load_gray(str(tmp_path / "a.pgm")),
                                  img.astype(np.float32))
    assert tnative.load_gray(str(tmp_path / "missing.pgm")) is None
    assert not list((tnative.SOURCE.parent).glob("*.so"))


# -- trajectory, trace, PLY, evaluation ----------------------------------------

def test_tum_trajectory_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.5, (5, 6)).astype(np.float32)
    tT, jT = tse3.SE3.exp(T(xi)), jse3.SE3.exp(jnp.asarray(xi))
    te = [ttraj.pose_entry(i * 0.1, tse3.SE3(tT.R[i], tT.t[i]))
          for i in range(5)]
    je = [jtraj.pose_entry(i * 0.1, jse3.SE3(jT.R[i], jT.t[i]))
          for i in range(5)]
    for (a, at, aq), (b, bt, bq) in zip(te, je):
        assert a == b
        np.testing.assert_allclose(at, bt, atol=1e-6)
        np.testing.assert_allclose(aq, bq, atol=1e-6)
    ttraj.write_tum(str(tmp_path / "t.txt"), te)
    jtraj.write_tum(str(tmp_path / "j.txt"), te)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    back = ttraj.read_tum(str(tmp_path / "t.txt"))
    for a, b in zip(back, jtraj.read_tum(str(tmp_path / "t.txt"))):
        np.testing.assert_array_equal(a, b)
    S = ttraj.tum_to_se3(back[1], back[2])
    np.testing.assert_allclose(S.R.numpy(), tT.R.numpy(), atol=1e-5)
    jS = jtraj.tum_to_se3(back[1], back[2])
    np.testing.assert_allclose(S.R.numpy(), np.asarray(jS.R), atol=1e-6)


def test_trace_writer_matches_jax(tmp_path):
    infos = [{"timestamp": 0.02, "proc_time": 0.1, "result": "no_keyframe",
              "sparse_img_align": 0.01, "img_align_n_tracked": 120,
              "repr_n_mps": 300, "n_seeds": 7, "frame_id": 1},
             {"timestamp": 0.04, "result": "failure", "reproject": 0.5}]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tw = ttrace.TraceWriter(str(tmp_path / "t"), "trace")
    jw = jtrace.TraceWriter(str(tmp_path / "j"), "trace")
    for info in infos:
        tw.log_frame(info)
        jw.log_frame(info)
    assert ttrace.TIMERS + ttrace.LOGS == jtrace.TIMERS + jtrace.LOGS
    assert open(tw.flush(), "rb").read() == open(jw.flush(), "rb").read()


@pytest.mark.parametrize("colors", [False, True])
def test_ply_bytes_match_jax(tmp_path, colors):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(20, 3))
    col = rng.integers(0, 255, (20, 3)) if colors else None
    tply.write_ply(str(tmp_path / "t.ply"), pts, col)
    jply.write_ply(str(tmp_path / "j.ply"), pts, col)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def test_evaluation_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    n = 60
    ts_gt = np.arange(n) / 30.0
    ts_est = np.sort(ts_gt[rng.permutation(n)[:45]]
                     + rng.uniform(-0.012, 0.012, 45))
    ta, tb = tate.associate(ts_est, ts_gt)
    ja, jb = jate.associate(ts_est, ts_gt)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    gt = rng.normal(size=(n, 3))
    R = np.asarray(jse3.quat_to_rot(jnp.asarray([0.1, 0.2, 0.3, 0.9])),
                   np.float64)
    est = 1.7 * gt @ R.T + rng.normal(0, 0.01, (n, 3))
    for scale in (True, False):
        a, b = tate.ate_rmse(gt, est, scale), jate.ate_rmse(gt, est, scale)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-9, abs=1e-12), k
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    Rg = np.asarray(jse3.quat_to_rot(jnp.asarray(q, jnp.float32)))
    Re = Rg @ np.asarray(jse3.SE3.exp(jnp.asarray(
        rng.normal(0, 0.01, (n, 6)), jnp.float32)).R)
    for delta in (1, 5):
        a = trpe.rpe(gt, Rg, est, Re, delta)
        b = jrpe.rpe(gt, Rg, est, Re, delta)
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-9, abs=1e-12), k
    errs = np.abs(rng.normal(0, 0.1, 300))
    for e in (errs, np.zeros((0,))):
        a, b = tdepth.depth_error_stats(e), jdepth.depth_error_stats(e)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-9)
    for th in (None, [0.0, 0.05, 10.0]):
        for x, y in zip(tdepth.precision_curve(errs, th),
                        jdepth.precision_curve(errs, th)):
            np.testing.assert_allclose(x, y, rtol=1e-9)
    p = tmp_path / "depth_error.txt"
    p.write_text("# header\n0.1\n0.5 0.2 0.3\n")
    np.testing.assert_array_equal(tdepth.load_depth_trace(str(p)),
                                  jdepth.load_depth_trace(str(p)))


# -- experiment composition ------------------------------------------------------

def test_experiment_layers_match_jax(tmp_path):
    (tmp_path / "vo_custom.yaml").write_text(
        "grid_size: 30\nmax_n_kfs: 10\nloba_num_iter: 0\ncam_topic: x\n")
    (tmp_path / "exp.yaml").write_text(
        "experiment_label: 'svo test'\nparam_settings: vo_custom\n"
        "datasets: [a, b]\nquality_min_fts: 40\n")
    (tmp_path / "ds").mkdir()
    (tmp_path / "ds" / "dataset_params.yaml").write_text(
        "dataset_is_blender: True\ncam0:\n  cam_model: Pinhole\n"
        "  cam_width: 640\n  cam_height: 480\n  cam_fx: 400.0\n"
        "  cam_fy: 401.0\n  cam_cx: 320.0\n  cam_cy: 240.0\n"
        "  cam_d0: -0.1\n")
    te, je = texp.load_experiment(str(tmp_path / "exp.yaml")), \
        jexp.load_experiment(str(tmp_path / "exp.yaml"))
    assert te.__dict__ == je.__dict__
    for name in ("vo_fast", "vo_accurate", "vo_custom"):
        tc = texp.load_algo_config(name, search_dirs=[str(tmp_path)])
        jc = jexp.load_algo_config(name, search_dirs=[str(tmp_path)])
        assert tc.__dict__ == jc.__dict__, name
        tc = texp.apply_param_overrides(tc, te.extra)
        assert tc.__dict__ == jexp.apply_param_overrides(jc, je.extra).__dict__
    dp = texp.load_dataset_params(str(tmp_path / "ds"))
    assert dp == jexp.load_dataset_params(str(tmp_path / "ds"))
    assert texp.load_dataset_params(str(tmp_path)) == {}
    _fields_close(texp.camera_from_params(dp), jexp.camera_from_params(dp))


def test_atan_dataset_params_camera_equals_the_yaml_loaders(tmp_path):
    """camera_from_params takes the ATAN block's normalized intrinsics as
    load_camera_yaml does.  The JAX package scales them twice
    (rpg_svo_tpu/io/experiment.py:103-107 before ATANCamera.make), which
    the port does not copy."""
    from test_camera_loader import ATAN_YAML
    (tmp_path / "camera_atan.yaml").write_text(ATAN_YAML)
    want = jloader.load_camera_yaml(str(tmp_path / "camera_atan.yaml"))
    params = {"cam0": {k: (v if k == "cam_model" else float(v)) for k, v in
                       jloader._parse_flat_yaml(
                           str(tmp_path / "camera_atan.yaml")).items()}}
    _fields_close(texp.camera_from_params(params), want)
    assert float(jexp.camera_from_params(params).fx) == pytest.approx(
        float(want.fx) * 752)


# -- the surface scene and the renderer through every camera -----------------------

@pytest.mark.parametrize("model", ["atan", "omni"])
def test_render_frame_through_the_camera_matches_jax(model):
    cams = {"atan": lambda m: m.ATANCamera.make(320, 240, *ATAN),
            "omni": lambda m: _omni(m, 320, 240, (1.0, 0.0, 0.0))}
    jds = jsyn.SyntheticDataset(n_frames=3, shape=(240, 320))
    T0 = jds.poses[2]
    ji, jd = jsyn.render_frame(cams[model](jcam), jds.tex, T0, (240, 320))
    ti, td = tsyn.render_frame(cams[model](tcam), tsyn.Texture.make(0),
                               tse3.SE3(T(T0.R), T(T0.t)), (240, 320))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4)
    ok = np.abs(ti.numpy() - np.asarray(ji)) < 0.5
    assert ok.mean() > 0.999, ok.mean()


def test_surface_scene_matches_jax():
    jds = jsyn.SurfaceDataset(n_frames=3, shape=(120, 160))
    tds = tsyn.SurfaceDataset(n_frames=3, shape=(120, 160), device="cpu")
    for i in (0, 2):
        ji, jd, jT = jds.frame(i)
        ti, td, tT = tds.frame(i)
        np.testing.assert_allclose(tT.t.numpy(), np.asarray(jT.t), atol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-3)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-3,
                                   rtol=1e-3)
    s = tsyn.SineSurface()
    xy = np.random.default_rng(5).normal(size=(50, 2)).astype(np.float32)
    np.testing.assert_allclose(s.height(T(xy)).numpy(),
                               np.asarray(jsyn.SineSurface().height(
                                   jnp.asarray(xy))), atol=1e-6)


def test_line_trajectory_dataset_matches_jax():
    jds = jsyn.SyntheticDataset(n_frames=4, trajectory="line", speed=0.03,
                                shape=(48, 64))
    tds = tsyn.SyntheticDataset(n_frames=4, trajectory="line", speed=0.03,
                                shape=(48, 64), device="cpu")
    for i in range(4):
        ji, jd, jT = jds.frame(i)
        ti, td, tT = tds.frame(i)
        np.testing.assert_allclose(tT.R.numpy(), np.asarray(jT.R), atol=1e-7)
        np.testing.assert_allclose(tT.t.numpy(), np.asarray(jT.t), atol=1e-7)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    with pytest.raises(ValueError):
        tsyn.SyntheticDataset(n_frames=2, trajectory="spiral", device="cpu")


# -- the handler with the ATAN camera, checkpoints, map_debug, viz ---------------

def _snapshot(fh):
    h = copy.copy(fh)
    h.initializer = copy.copy(fh.initializer)
    h.log = []
    return h


@pytest.fixture(scope="module")
def atan_run():
    """The JAX FrameHandler (fast, the whole-step config of
    tests/_torch_port.py) from ground-truth depth on the small scene
    rendered through the ATAN camera, N_FRAMES frames, with a snapshot
    after frame 5."""
    jds = jsyn.SyntheticDataset(**FULL_SCENE)
    jc = jcam.ATANCamera.make(SHAPE[1], SHAPE[0], *ATAN)
    frames = [jsyn.render_frame(jc, jds.tex, jds.poses[i], SHAPE)
              for i in range(N_FRAMES + 1)]
    imgs = [np.asarray(f[0]) for f in frames]
    jfh = JFrameHandler(jc, jconfig.fast_preset(**FULL_KW), img_shape=SHAPE)
    T0 = jds.poses[0]
    jfh.set_first_frame_with_depth(jnp.asarray(imgs[0]), T0.inverse(),
                                   frames[0][1])
    infos, t_wc, snap = [], [], None
    for i in range(1, N_FRAMES + 1):
        infos.append(jfh.add_image(jnp.asarray(imgs[i]), i / 50.0))
        t_wc.append(np.asarray(jfh.last_frame.T_f_w.inverse().t))
        if i == 5:
            snap = _snapshot(jfh)
    return dict(imgs=imgs, depth0=np.asarray(frames[0][1]), T0=T0,
                infos=infos, t_wc=t_wc, snap=snap, jfh=jfh,
                cam=tcam.ATANCamera.make(SHAPE[1], SHAPE[0], *ATAN),
                tcfg=tconfig.fast_preset(**FULL_KW))


def test_atan_handler_matches_jax(atan_run):
    r = atan_run
    fh = FrameHandler(r["cam"], r["tcfg"], SHAPE, device="cpu")
    T0 = r["T0"].inverse()
    fh.set_first_frame_with_depth(r["imgs"][0], tse3.SE3(T(T0.R), T(T0.t)),
                                  r["depth0"])
    kfs = []
    for i in range(1, N_FRAMES + 1):
        info = fh.add_image(r["imgs"][i], i / 50.0)
        want = r["infos"][i - 1]
        assert info["result"] == want["result"] != "failure", i
        assert info["stage"] == want["stage"], i
        assert bool(info.get("is_keyframe")) == bool(want.get("is_keyframe"))
        kfs += [i] if info.get("is_keyframe") else []
        np.testing.assert_allclose(
            fh.last_frame.T_f_w.inverse().t.numpy(), r["t_wc"][i - 1],
            atol=1e-4, err_msg=f"frame {i}")
    assert kfs, "the run holds no keyframe"


# the Omni camera on the bench scene (752x480, bench_cfg("fast")): frames
# 1-OMNI_FRAMES agree to ~1.5e-6 m; from frame 53 on, a pose optimization
# that two Gauss-Newton steps move by 2% takes float-noise differences in
# the feature positions (1e-5 in the bearings) to 1e-4 m and more, and the
# two runs part by up to ~1.5 mm (PERF.md, "The Omni split")
OMNI_FRAMES = 30


@pytest.fixture(scope="module")
def omni_run():
    """The JAX FrameHandler (bench_cfg("fast")) from ground-truth depth on
    the bench scene rendered through the Omni camera of
    tests/test_cameras.py, frames 1-OMNI_FRAMES."""
    import dataclasses

    import jax
    jc = _omni(jcam, stretch=(1.0, 0.0, 0.0))
    jds = jsyn.SyntheticDataset(n_frames=441, trajectory="circle",
                                radius=0.25, revolutions=0.5)
    render = jax.jit(lambda T: jsyn.render_frame(jc, jds.tex, T, jds.shape))
    frames = [render(jds.poses[i]) for i in range(OMNI_FRAMES + 1)]
    tcfg = tconfig.bench_cfg("fast")
    jfh = JFrameHandler(jc, jconfig.Config(**dataclasses.asdict(tcfg)))
    jfh.set_first_frame_with_depth(frames[0][0], jds.poses[0].inverse(),
                                   frames[0][1])
    infos, t_wc = [], []
    for i in range(1, OMNI_FRAMES + 1):
        infos.append(jfh.add_image(frames[i][0], i / 50.0))
        t_wc.append(np.asarray(jfh.last_frame.T_f_w.inverse().t))
    return dict(imgs=[np.array(f[0]) for f in frames],
                depth0=np.array(frames[0][1]), T0=jds.poses[0],
                shape=tuple(jds.shape), infos=infos, t_wc=t_wc, tcfg=tcfg,
                cam=_omni(tcam, stretch=(1.0, 0.0, 0.0)))


def test_omni_handler_matches_jax(omni_run):
    r = omni_run
    fh = FrameHandler(r["cam"], r["tcfg"], r["shape"], device="cpu")
    T0 = r["T0"].inverse()
    fh.set_first_frame_with_depth(T(r["imgs"][0]), tse3.SE3(T(T0.R), T(T0.t)),
                                  T(r["depth0"]))
    for i in range(1, OMNI_FRAMES + 1):
        info = fh.add_image(T(r["imgs"][i]), i / 50.0)
        want = r["infos"][i - 1]
        assert info["result"] == want["result"] != "failure", i
        for k in ("stage", "img_align_n_tracked", "repr_n_mps",
                  "sfba_n_edges_final"):
            assert info[k] == want[k], (i, k)
        np.testing.assert_allclose(
            fh.last_frame.T_f_w.inverse().t.numpy(), r["t_wc"][i - 1],
            atol=1e-4, err_msg=f"frame {i}")


def _handlers_equal(t, j):
    """Two handler trees (handler_to_numpy layout) exactly equal, the
    bootstrap state aside."""
    for store in ("kf", "pt", "seed"):
        for k in j["map"][store]:
            close(t["map"][store][k], j["map"][store][k], f"{store}.{k}", 0.0)
    close(t["map"]["kf_counter"], j["map"]["kf_counter"], "kf_counter", 0.0)
    for k, v in j["last_frame"].items():
        if k == "pad":
            close(t["last_frame"][k]["stack"], v["stack"], "pad", 0.0)
        elif k == "timestamp":
            assert float(t["last_frame"][k]) == pytest.approx(float(v))
        else:
            close(t["last_frame"][k], v, k, 0.0)
    for k in ("stage", "quality", "num_obs_last", "next_id"):
        assert t[k] == j[k], k


def test_jax_checkpoint_resumes_in_the_port(atan_run, tmp_path):
    r = atan_run
    path = str(tmp_path / "jax_ckpt.npz")
    jckpt.save_handler(path, r["snap"])
    fh = FrameHandler(r["cam"], r["tcfg"], SHAPE, device="cpu")
    tckpt.load_handler(path, fh)
    _handlers_equal(handler_to_numpy(fh), jax_handler_tree(r["snap"]))
    # and it tracks on as the converted handler does
    ref = handler_from_numpy(jax_handler_tree(r["snap"]), r["cam"], r["tcfg"],
                             SHAPE, device="cpu")
    for i in (6, 7):
        fh.add_image(r["imgs"][i], i / 50.0)
        ref.add_image(r["imgs"][i], i / 50.0)
        np.testing.assert_array_equal(fh.last_frame.t.numpy(),
                                      ref.last_frame.t.numpy())


def test_port_checkpoint_resumes_in_jax(atan_run, tmp_path):
    r = atan_run
    fh = handler_from_numpy(jax_handler_tree(r["snap"]), r["cam"], r["tcfg"],
                            SHAPE, device="cpu")
    path = str(tmp_path / "port_ckpt.npz")
    tckpt.save_handler(path, fh)
    jfh = JFrameHandler(jcam.ATANCamera.make(SHAPE[1], SHAPE[0], *ATAN),
                        jconfig.fast_preset(**FULL_KW), img_shape=SHAPE)
    jckpt.load_handler(path, jfh)
    want = jax_handler_tree(r["snap"])
    got = jax_handler_tree(jfh)
    _handlers_equal(got, want)
    # the port's own round trip
    fh2 = FrameHandler(r["cam"], r["tcfg"], SHAPE, device="cpu")
    tckpt.load_handler(path, fh2)
    _handlers_equal(handler_to_numpy(fh2), want)


def test_map_checkpoints_cross_packages(atan_run, tmp_path):
    r = atan_run
    m = map_from_numpy(jax_handler_tree(r["jfh"])["map"], device="cpu")
    tckpt.save_map(str(tmp_path / "t.npz"), m)
    back = jckpt.load_map(str(tmp_path / "t.npz"), r["jfh"].map)
    jckpt.save_map(str(tmp_path / "j.npz"), back)
    empty = FrameHandler(r["cam"], r["tcfg"], SHAPE, device="cpu").map
    got = tckpt.load_map(str(tmp_path / "j.npz"), empty)
    for a, b in zip(tckpt._leaves(got), tckpt._leaves(m)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    small = FrameHandler(r["cam"], r["tcfg"].replace(max_points=64), SHAPE,
                         device="cpu").map
    with pytest.raises(ValueError, match="capacity"):
        tckpt.load_map(str(tmp_path / "j.npz"), small)


def test_map_debug_matches_jax(atan_run):
    jm = atan_run["jfh"].map
    m = map_from_numpy(jax_handler_tree(atan_run["jfh"])["map"], device="cpu")
    assert tmap_debug.map_statistics(m) == jmap_debug.map_statistics(jm)
    assert tmap_debug.validate_map(m) == jmap_debug.validate_map(jm) == []
    # a keyframe feature on a deleted point, a seed on a free keyframe slot
    kf = np.where(m.kf.active.numpy())[0][0]
    f = int(np.where(m.kf.feat_valid[kf].numpy()
                     & (m.kf.feat_point[kf].numpy() >= 0))[0][0])
    p = int(m.kf.feat_point[kf, f])
    free = int(np.where(~m.kf.active.numpy())[0][0])
    ptype = m.pt.ptype.clone()
    ptype[p] = 0
    kf_slot = m.seed.kf_slot.clone()
    kf_slot[0] = free
    active = m.seed.active.clone()
    active[0] = True
    bad = m._replace(pt=m.pt._replace(ptype=ptype),
                     seed=m.seed._replace(kf_slot=kf_slot, active=active))
    jbad = jm._replace(
        pt=jm.pt._replace(ptype=jnp.asarray(ptype.numpy())),
        seed=jm.seed._replace(kf_slot=jnp.asarray(kf_slot.numpy()),
                              active=jnp.asarray(active.numpy())))
    got = tmap_debug.validate_map(bad)
    assert got == jmap_debug.validate_map(jbad) and len(got) >= 2
    assert tmap_debug.map_statistics(bad) == jmap_debug.map_statistics(jbad)


def test_viz_records_match_jax(atan_run):
    jfh = atan_run["jfh"]
    m = map_from_numpy(jax_handler_tree(jfh)["map"], device="cpu")
    lf = jfh.last_frame
    tT = tse3.SE3(T(lf.R), T(lf.t))
    tm, jm = tviz.markers_from_map(m, tT, 3), \
        jviz.markers_from_map(jfh.map, lf.T_f_w, 3)
    for k, v in jm.__dict__.items():
        np.testing.assert_allclose(getattr(tm, k), v, atol=1e-5, err_msg=k)
    img = atan_run["imgs"][N_FRAMES]
    args = (lf.feat_px, lf.feat_valid)
    np.testing.assert_array_equal(
        tviz.draw_features(T(img), T(np.asarray(lf.feat_px)),
                           T(np.asarray(lf.feat_valid)),
                           feat_type=T(np.asarray(lf.feat_type)),
                           grad=T(np.asarray(lf.feat_grad))),
        jviz.draw_features(img, *args, feat_type=lf.feat_type,
                           grad=lf.feat_grad))
    px2 = np.asarray(lf.feat_px) + 3.0
    np.testing.assert_array_equal(
        tviz.draw_init_tracks(img, np.asarray(lf.feat_px), px2,
                              np.asarray(lf.feat_valid)),
        jviz.draw_init_tracks(img, lf.feat_px, px2, lf.feat_valid))
    pts = np.random.default_rng(6).normal(0, 1, (30, 3)).astype(np.float32)
    pts[:, 2] += 1.0
    td = tviz.dense_input_from_frame(4, 0.1, T(img), tT, T(pts))
    jd = jviz.dense_input_from_frame(4, 0.1, img, lf.T_f_w, pts)
    for k, v in jd.__dict__.items():
        np.testing.assert_allclose(getattr(td, k), v, atol=1e-6, err_msg=k)
    cov = np.diag(np.arange(1.0, 7.0))
    tp, tc = tviz.pose_with_covariance(tT, cov)
    jp, jc = jviz.pose_with_covariance(lf.T_f_w, cov)
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-6)
    assert tviz.pose_with_covariance(tT, cov, True)[1] is not None
    fr = handler_from_numpy(jax_handler_tree(jfh), atan_run["cam"],
                            atan_run["tcfg"], SHAPE, device="cpu").last_frame
    assert tviz.features_from_frame(fr, 50) == [
        tviz.FeatureMsg(*f.__dict__.values())
        for f in jviz.features_from_frame(lf, 50)]
    info = {"frame_id": 3, "timestamp": 0.5, "proc_time": 0.02,
            "repr_n_new_references": 90, "stage": "default",
            "is_keyframe": True}
    ti, ji = tviz.Info.from_frame_info(info, "bad"), \
        jviz.Info.from_frame_info(info, "bad")
    assert ti.__dict__ == ji.__dict__
    ts, js = tviz.InfoStream(3), jviz.InfoStream(3)
    for k in range(5):
        rec = tviz.Info.from_frame_info(dict(info, proc_time=0.01 * (k + 1)))
        ts.push(rec)
        js.push(jviz.Info.from_frame_info(dict(info,
                                               proc_time=0.01 * (k + 1))))
    assert ts.fps == pytest.approx(js.fps)
    assert tviz.status_line(ti, ts.fps) == jviz.status_line(ji, js.fps)
    assert tviz.NbvTrajectory([0.0], [(1, 2, 3)], [(1, 0, 0, 0)]).__dict__ \
        == jviz.NbvTrajectory([0.0], [(1, 2, 3)], [(1, 0, 0, 0)]).__dict__
