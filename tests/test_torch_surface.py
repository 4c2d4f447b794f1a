"""The port's public functions off the main path against the JAX package
on the CPU, the interpolant schedule of feature alignment, and a guard
that every public name of the JAX package has its counterpart.

Scene: frames 0 and 4 of a 0.03 m/frame line at 240x320 (the JAX
renderer), as tests/test_matcher.py uses at 752x480; both packages get
the same numpy arrays.  Tolerances: aligned and matched positions to
1e-3 px with equal convergence flags (window sums in another order over
up to 20 Gauss-Newton iterations); triangulated depths to 1e-3 relative
(tests/test_torch_depth_filter.py explains the conditioning); samplers and
closed-form geometry to 1e-5 relative; every discrete result exactly.

Feature alignment interpolates iteration ``it`` of ``n_iter`` bilinearly
unless ``it >= n_iter - BICUBIC_LAST`` (rpg_svo_tpu/ops/feature_align.py:
231).  ``Config.subpix_n_iter`` is read by neither package (the
reprojector and the depth filter align with the default 10 iterations),
so on the main path the schedule matters only when SVO_BICUBIC_LAST is
below 10; the handler test below sets it to 3 in both packages.
"""

import ast
import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_svo_tpu import config as jconfig
from rpg_svo_tpu.core.pipeline import FrameHandler as JFrameHandler
from rpg_svo_tpu.geometry import cameras as jcam
from rpg_svo_tpu.geometry import linalg as jlinalg
from rpg_svo_tpu.geometry import triangulation as jtri
from rpg_svo_tpu.geometry.se3 import SE3 as JSE3
from rpg_svo_tpu.ops import detector as jdet
from rpg_svo_tpu.ops import feature_align as jfa
from rpg_svo_tpu.ops import interp as jinterp
from rpg_svo_tpu.ops import matcher as jm
from rpg_svo_tpu.ops import point_opt as jpo
from rpg_svo_tpu.ops.pyramid import build_padded_pyramid as jbuild_pad
from rpg_svo_tpu.ops.pyramid import build_pyramid as jbuild_pyr
from rpg_svo_tpu.utils.synthetic import SyntheticDataset
from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch.core import map as tmap
from rpg_svo_tpu_torch.core.convert import handler_from_numpy
from rpg_svo_tpu_torch.core.pipeline import FrameHandler
from rpg_svo_tpu_torch.geometry import cameras as tcam
from rpg_svo_tpu_torch.geometry import linalg as tlinalg
from rpg_svo_tpu_torch.geometry import triangulation as ttri
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3
from rpg_svo_tpu_torch.ops import detector as tdet
from rpg_svo_tpu_torch.ops import feature_align as tfa
from rpg_svo_tpu_torch.ops import interp as tinterp
from rpg_svo_tpu_torch.ops import matcher as tm
from rpg_svo_tpu_torch.ops import point_opt as tpo
from rpg_svo_tpu_torch.ops.tiles import PaddedPyramid as TPad
from rpg_svo_tpu_torch.utils.synthetic import reference_test_camera

from _torch_port import (FULL_KW, FULL_SCENE, SHAPE, close,
                         jax_handler_tree)

PX_TOL = 1e-3
DEPTH_RTOL = 1e-3
ROOT = pathlib.Path(__file__).resolve().parent.parent


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    ds = SyntheticDataset(n_frames=6, trajectory="line", speed=0.03,
                          shape=SHAPE)
    img0, depth0, T0 = ds.frame(0)
    img1, _, T1 = ds.frame(4)
    pyr0, pyr1 = jbuild_pyr(img0, 5), jbuild_pyr(img1, 5)
    jpad0, jpad1 = jbuild_pad(img0, 5), jbuild_pad(img1, 5)
    Tcr = T1.inverse() * T0
    return dict(
        ds=ds, img0=img0, img1=img1, depth0=np.asarray(depth0), Tcr=Tcr,
        tTcr=TSE3(T(Tcr.R), T(Tcr.t)),
        pyr0=pyr0, pyr1=pyr1, jpad0=jpad0, jpad1=jpad1,
        tpyr0=[T(l) for l in pyr0], tpyr1=[T(l) for l in pyr1],
        tpad0=TPad.from_stack(T(jpad0.stack), jpad0.shapes),
        tpad1=TPad.from_stack(T(jpad1.stack), jpad1.shapes),
        tcam=reference_test_camera(SHAPE[1], SHAPE[0]))


def _sources(s, src):
    """(JAX image source, port image source, level images) of frame 4."""
    if src == "padded":
        return s["jpad1"], s["tpad1"], s["jpad1"].levels()
    if src == "flat":
        return (jinterp.FlatPyramid(s["pyr1"]),
                tinterp.FlatPyramid.from_levels(s["tpyr1"]), s["pyr1"])
    return s["img1"], T(s["img1"]), [s["img1"]]


def _align_inputs(levels, seed, n=96, offset=2.5):
    """Mixed 1-D/2-D items on levels 0-2 (0 for a raw image): bordered
    patches cut at px, starts up to ``offset`` px away."""
    rng = np.random.default_rng(seed)
    lv = rng.integers(0, min(3, len(levels)), n).astype(np.int32)
    shp = np.asarray([l.shape for l in levels])[lv]
    px = rng.uniform([12, 12], shp[:, ::-1] - 12).astype(np.float32)
    patches = np.zeros((n, 100), np.float32)
    for l in np.unique(lv):
        sel = lv == l
        patches[sel] = np.asarray(jfa.extract_patch_with_border(
            levels[l], jnp.asarray(px[sel]))[0])
    ang = rng.uniform(0, 2 * np.pi, n)
    return dict(
        patches=patches, lv=lv,
        start=(px + rng.uniform(-offset, offset, (n, 2))).astype(np.float32),
        valid=rng.random(n) > 0.1, is_1d=rng.random(n) < 0.3,
        direction=np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32))


@pytest.mark.parametrize("src", ["padded", "flat", "raw"])
@pytest.mark.parametrize("n_iter,last", [(10, 10), (15, 10), (15, 3)],
                         ids=["n10", "n15", "n15_last3"])
def test_align_schedule_matches_jax(scene, monkeypatch, src, n_iter, last):
    """The bilinear-then-cubic schedule on each image source: from n_iter
    - BICUBIC_LAST iterations of the 2-tap bilinear window (support test
    over 4 taps per pixel where the tile has invalid pixels) to the cubic
    ones.  A jit of a new function traces JAX with the patched constant
    (JAX keys its traces by the function, not by the jit object)."""
    monkeypatch.setattr(jfa, "BICUBIC_LAST", last)
    monkeypatch.setattr(tfa, "BICUBIC_LAST", last)
    jsrc, tsrc, levels = _sources(scene, src)
    a = _align_inputs(levels, seed=n_iter * 10 + last)
    lv = None if src == "raw" else a["lv"]
    jal = jax.jit(lambda *a_, **k_: jfa.align_features.__wrapped__(*a_, **k_),
                  static_argnames=("n_iter",))
    pj, cj = jal(jsrc, jnp.asarray(a["patches"]), jnp.asarray(a["start"]),
                 jnp.asarray(a["valid"]), n_iter=n_iter,
                 level=None if lv is None else jnp.asarray(lv),
                 direction=jnp.asarray(a["direction"]),
                 is_1d=jnp.asarray(a["is_1d"]))
    pt, ct = tfa.align_features(tsrc, T(a["patches"]), T(a["start"]),
                                T(a["valid"]), n_iter=n_iter,
                                level=None if lv is None else T(lv),
                                direction=T(a["direction"]),
                                is_1d=T(a["is_1d"]))
    close(ct.numpy(), cj, "converged", 0)
    assert np.asarray(cj).mean() > 0.5
    close(pt.numpy(), pj, "px", PX_TOL, rtol=0)


def test_align1d_and_align2d_on_raw_image_match_jax(scene):
    """align1d along (0.6, 0.8) and align2d over 20 iterations (10
    bilinear, 10 cubic) from known offsets, as tests/test_feature_align.py
    drives them, with the patches of extract_patch_with_border."""
    img = scene["img0"]
    rng = np.random.default_rng(5)
    px = rng.uniform([20, 20], [SHAPE[1] - 20, SHAPE[0] - 20],
                     (64, 2)).astype(np.float32)
    jp, jok = jfa.extract_patch_with_border(img, jnp.asarray(px))
    tp, tok = tfa.extract_patch_with_border(T(img), T(px))
    close(tok.numpy(), jok, "patch ok", 0)
    close(tp.numpy(), jp, "patches", 1e-4, rtol=1e-5)
    d = np.tile(np.float32([[0.6, 0.8]]), (64, 1))
    ones = np.ones(64, bool)
    j1, c1 = jfa.align1d(img, jp, jnp.asarray(px + 1.8 * d), jnp.asarray(d),
                         jnp.asarray(ones), n_iter=20)
    t1, k1 = tfa.align1d(T(img), T(jp), T(px + 1.8 * d), T(d), T(ones),
                         n_iter=20)
    close(k1.numpy(), c1, "1-D converged", 0)
    close(t1.numpy(), j1, "1-D px", PX_TOL, rtol=0)
    j2, c2 = jfa.align2d(img, jp, jnp.asarray(px + [1.7, -1.3]),
                         jnp.asarray(ones), n_iter=20)
    t2, k2 = tfa.align2d(T(img), T(jp), T(px + [1.7, -1.3]), T(ones),
                         n_iter=20)
    close(k2.numpy(), c2, "2-D converged", 0)
    assert np.asarray(c2).mean() > 0.8
    close(t2.numpy(), j2, "2-D px", PX_TOL, rtol=0)


def _direct_inputs(s):
    """Detected corners of frame 0 with ground-truth depth, projected
    into frame 4 and perturbed by (2, -1.5) px (tests/test_matcher.py)."""
    ncx, ncy = jdet.grid_dims(SHAPE[1], SHAPE[0], 25)
    feats = jdet.detect_features(s["pyr0"], jnp.zeros((ncx * ncy,), bool),
                                 25)
    px = np.asarray(feats["px"])
    f = np.asarray(s["ds"].cam.cam2world(feats["px"]))
    xi = np.clip(px[:, 0].astype(int), 0, SHAPE[1] - 1)
    yi = np.clip(px[:, 1].astype(int), 0, SHAPE[0] - 1)
    d = s["depth0"][yi, xi]
    px_gt = np.asarray(s["ds"].cam.world2cam(s["Tcr"].apply(
        jnp.asarray(f * d[:, None]))))
    valid = np.asarray(feats["valid"]) & np.isfinite(d) & np.asarray(
        s["ds"].cam.is_in_frame(jnp.asarray(px_gt), boundary=10.0))
    n = len(px)
    rng = np.random.default_rng(7)
    ang = rng.uniform(0, 2 * np.pi, n)
    return dict(px=px, f=f.astype(np.float32), lv=np.asarray(feats["level"]),
                d=d.astype(np.float32), valid=valid,
                init=(px_gt + np.float32([2.0, -1.5])).astype(np.float32),
                ftype=(rng.random(n) < 0.4).astype(np.int32),
                grad=np.stack([np.cos(ang), np.sin(ang)], -1)
                .astype(np.float32))


@pytest.mark.parametrize("edgelets", [False, True],
                         ids=["corners", "edgelets"])
@pytest.mark.parametrize("cur", ["flat", "padded"])
def test_find_match_direct_matches_jax(scene, cur, edgelets):
    """Matcher::findMatchDirect with FlatPyramid reference and current
    pyramids (tests/test_matcher.py), or the padded current pyramid (K1's
    tiles); edgelets refine 1-D along the warped gradient."""
    s = scene
    b = _direct_inputs(s)
    jcur = jinterp.FlatPyramid(s["pyr1"]) if cur == "flat" else s["jpad1"]
    tcur = tinterp.FlatPyramid.from_levels(s["tpyr1"]) if cur == "flat" \
        else s["tpad1"]
    kw = dict(ftr_type=b["ftype"], ftr_grad=b["grad"]) if edgelets else {}
    args = ("px", "f", "lv", "d", "init", "valid")
    want = jm.find_match_direct(
        jcur, jinterp.FlatPyramid(s["pyr0"]), s["ds"].cam, s["Tcr"],
        *[jnp.asarray(b[k]) for k in args],
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tm.find_match_direct(
        tcur, tinterp.FlatPyramid.from_levels(s["tpyr0"]), s["tcam"],
        s["tTcr"], *[T(b[k]) for k in args],
        **{k: T(v) for k, v in kw.items()})
    close(got.level_cur.numpy(), want.level_cur, "level", 0)
    close(got.success.numpy(), want.success, "success", 0)
    ok = np.asarray(want.success) & b["valid"]
    assert ok.sum() > 0.4 * b["valid"].sum()
    close(got.px_cur.numpy(), want.px_cur, "px_cur", PX_TOL, rtol=0)
    close(got.grad_cur.numpy(), want.grad_cur, "grad_cur", 1e-5)


@pytest.mark.parametrize("align_1d", [False, True], ids=["2d", "1d"])
def test_epipolar_match_align_1d_matches_jax(scene, align_1d):
    """The epipolar search of frame 0's corners in frame 4 (d in [0.7,
    1.4] x truth, a third of them edgelets), refined 2-D or along the
    epipolar line.  JAX runs epipolar_match's steps on the padded
    pyramids, as the port's epipolar_match does."""
    s = scene
    b = _direct_inputs(s)
    n = len(b["px"])
    args = (b["px"], b["f"], b["lv"], b["d"], 0.7 * b["d"], 1.4 * b["d"])
    gj = jm.epipolar_geometry(s["ds"].cam, s["Tcr"],
                              *map(jnp.asarray, args))
    ref = s["jpad0"].flat_view()
    rb, okb = jm.warp_affine_patches(gj.A, ref, jnp.asarray(b["px"]),
                                     jnp.asarray(b["lv"]), gj.search_level)
    rr, okr = jm.warp_patches_rotated(gj.A, ref, jnp.asarray(b["px"]),
                                      jnp.asarray(b["lv"]), gj.search_level,
                                      gj.dir_lvl)
    want = jm.epipolar_search(
        s["jpad1"].flat_view(), s["ds"].cam, gj, s["Tcr"],
        jnp.asarray(b["f"]), rb, rr, okb & okr, jnp.asarray(b["valid"]),
        ftr_type=jnp.asarray(b["ftype"]), ftr_grad=jnp.asarray(b["grad"]),
        align_1d=align_1d, cur_pad=s["jpad1"])
    got = tm.epipolar_match(
        s["tpad1"], s["tpad0"], s["tcam"], s["tTcr"], *map(T, args),
        T(b["valid"]), ftr_type=T(b["ftype"]), ftr_grad=T(b["grad"]),
        align_1d=align_1d)
    for k in ("level_cur", "success", "scanned"):
        close(getattr(got, k).numpy(), getattr(want, k), k, 0)
    ok = np.asarray(want.success)
    assert ok.sum() > n // 4
    close(got.px_cur.numpy()[ok], np.asarray(want.px_cur)[ok], "px_cur",
          PX_TOL, rtol=0)
    close(got.depth_ref.numpy()[ok], np.asarray(want.depth_ref)[ok],
          "depth_ref", 1e-6, rtol=DEPTH_RTOL)
    assert tm.ZMSSD_THRESHOLD == jm.ZMSSD_THRESHOLD


def test_extract_patches_matches_jax(scene):
    """Bilinear patches (tests/test_image_ops.py::test_extract_patches),
    centers inside, on the border and outside."""
    img = scene["img0"]
    rng = np.random.default_rng(2)
    c = rng.uniform([-6, -6], [SHAPE[1] + 6, SHAPE[0] + 6],
                    (200, 2)).astype(np.float32)
    for half, border in ((4, 0), (4, 1), (2, 0)):
        jv, jok = jinterp.extract_patches(img, jnp.asarray(c), half, border)
        tv, tok = tinterp.extract_patches(T(img), T(c), half, border)
        close(tok.numpy(), jok, "valid", 0)
        assert 0 < np.asarray(jok).sum() < len(c)
        close(tv.numpy(), jv, "patches", 1e-4, rtol=1e-5)


def test_bound_pyramid_pool_matches_jax(scene):
    """Bilinear samples of pyramid idx[i] (clamped, idx -1 included) of a
    (3, L) pool, at per-item levels broadcast against (N, P, 2) coords."""
    s = scene
    imgs = [s["img0"], s["img1"], s["img0"] * 0.5 + 7.0]
    pyrs = [jbuild_pyr(im, 4) for im in imgs]
    pool = np.stack([np.concatenate([np.asarray(l).ravel() for l in p])
                     for p in pyrs])
    shapes = [tuple(l.shape) for l in pyrs[0]]
    rng = np.random.default_rng(4)
    n, p = 64, 9
    idx = rng.integers(-1, 4, n).astype(np.int32)
    lv = rng.integers(0, 4, n).astype(np.int32)
    centers = rng.uniform([-2, -2], [SHAPE[1], SHAPE[0]], (n, 1, 2)) \
        / (2.0 ** lv)[:, None, None]
    xy = (centers + rng.uniform(-2, 2, (n, p, 2))).astype(np.float32)
    jv, jok = jinterp.BoundPyramidPool(jnp.asarray(pool), shapes,
                                       jnp.asarray(idx)).bilinear(
        jnp.asarray(lv)[:, None], jnp.asarray(xy))
    tv, tok = tinterp.BoundPyramidPool(T(pool), shapes, T(idx)).bilinear(
        T(lv)[:, None], T(xy))
    close(tok.numpy(), jok, "valid", 0)
    assert 0 < np.asarray(jok).mean() < 1
    close(tv.numpy(), jv, "samples", 1e-4, rtol=1e-5)


def test_image_gradients_wrap_like_jax():
    """Central differences that wrap around at the borders (jnp.roll)."""
    img = np.random.default_rng(1).uniform(0, 255, (37, 53)) \
        .astype(np.float32)
    for t_, j_ in zip(tinterp.image_gradients(T(img)),
                      jinterp.image_gradients(jnp.asarray(img))):
        close(t_.numpy(), j_, "gradient", 1e-5)


@pytest.mark.parametrize("k", [16, 64, 200])
def test_select_top_k_matches_lax_top_k(k):
    """Scores with many ties and invalid entries: the same indices in the
    same order as lax.top_k (lower index first among ties), -1 padding."""
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 6, 256).astype(np.float32)
    valid = rng.random(256) > 0.4
    want = jdet.select_top_k(jnp.asarray(scores), jnp.asarray(valid), k)
    got = tdet.select_top_k(T(scores), T(valid), k)
    close(got.numpy(), want, "top k", 0)


def test_observations_struct_and_n_obs_match_jax():
    js, ts = jpo.observations_struct(5, 3), tpo.observations_struct(5, 3)
    assert sorted(js) == sorted(ts)
    for k in js:
        close(ts[k].numpy(), js[k], k, 0)
    obs_valid = np.random.default_rng(0).random((40, 6)) > 0.5
    pts = tmap.init_map(2, 4, 40, 6, 4, (8, 256), device="cpu").pt
    got = pts._replace(obs_valid=T(obs_valid)).n_obs
    close(got.numpy(), jnp.sum(jnp.asarray(obs_valid), axis=-1), "n_obs", 0)


def test_camera_surface_matches_jax():
    """has_distortion on the distorted and the ideal pinhole, unproject2d,
    and solve2x2 on damped random systems."""
    kw = (752, 480, 315.5, 315.5, 376.0, 240.0)
    for dist in ((), (-0.28, 0.07, 2e-4, 1.8e-5)):
        assert tcam.PinholeCamera.make(*kw, *dist).has_distortion \
            == jcam.PinholeCamera.make(*kw, *dist).has_distortion
    rng = np.random.default_rng(3)
    uv = rng.normal(size=(7, 2)).astype(np.float32)
    close(tcam.unproject2d(T(uv)).numpy(),
          jcam.unproject2d(jnp.asarray(uv)), "unproject2d", 0)
    A = (rng.normal(size=(50, 2, 2)) + 3 * np.eye(2)).astype(np.float32)
    b = rng.normal(size=(50, 2)).astype(np.float32)
    close(tlinalg.solve2x2(T(A), T(b)).numpy(),
          jlinalg.solve2x2(jnp.asarray(A), jnp.asarray(b)), "solve2x2", 1e-5)


def test_se3_and_triangulation_surface_matches_jax():
    """SE3.matrix / from_matrix / normalize (of a drifted rotation),
    jacobian_proj_point and reprojection_error_unitplane."""
    rng = np.random.default_rng(8)
    xi = rng.normal(scale=0.5, size=(20, 6)).astype(np.float32)
    jT = JSE3.exp(jnp.asarray(xi))
    tT = TSE3.exp(T(xi))
    close(tT.matrix().numpy(), jT.matrix(), "matrix", 1e-5)
    M = np.asarray(jT.matrix()) + rng.normal(scale=1e-3, size=(20, 4, 4)) \
        .astype(np.float32)
    jn = JSE3.from_matrix(jnp.asarray(M)).normalize()
    tn = TSE3.from_matrix(T(M)).normalize()
    close(tn.R.numpy(), jn.R, "normalize R", 1e-5)
    close(tn.t.numpy(), jn.t, "from_matrix t", 0)
    p = rng.uniform([-1, -1, 1], [1, 1, 4], (20, 3)).astype(np.float32)
    fm = p + rng.normal(scale=0.01, size=p.shape).astype(np.float32)
    close(ttri.jacobian_proj_point(T(p), tT.R).numpy(),
          jtri.jacobian_proj_point(jnp.asarray(p), jT.R), "J", 1e-5)
    close(ttri.reprojection_error_unitplane(T(p), T(fm)).numpy(),
          jtri.reprojection_error_unitplane(jnp.asarray(p), jnp.asarray(fm)),
          "residual", 1e-6)


# --- the completeness guard ------------------------------------------------
# Not ported on purpose: the Pallas files (the kernels K1 and K2 are csrc/
# with ops/tiles.py and ops/align_kernel.py), the TPU one-hot helpers and
# the JAX pytree methods.
NOT_PORTED = {
    "ba/schur.py": {"obs_cam_onehot", "var_onehot"},
    "geometry/linalg.py": {"onehot_gather_rows"},
}
NOT_PORTED_FILES = ("ops/pallas_align.py", "ops/pallas_tiles.py")
PYTREE_METHODS = {"tree_flatten", "tree_unflatten"}


def _is_jit_alias(value) -> bool:
    """An assignment of jax.jit(...) or functools.partial(jax.jit, ...)(f):
    a compiled alias of a function listed on its own.  One that donates
    its arguments (``donate_argnums``) behaves otherwise, consuming its
    input, so it is a public name of its own."""
    return isinstance(value, ast.Call) and "jax.jit" in ast.unparse(
        value.func) and "donate_argnums" not in ast.unparse(value)


def _public_names(path: pathlib.Path):
    """Top-level functions, classes, constants and class-level methods and
    fields of a reference file whose names do not start with _."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef)
                          and not m.name.startswith("_")
                          and m.name not in PYTREE_METHODS]
                names += [f"{node.name}.{m.target.id}" for m in node.body
                          if isinstance(m, ast.AnnAssign)
                          and isinstance(m.target, ast.Name)]
        elif isinstance(node, ast.Assign) and not _is_jit_alias(node.value):
            names += [t.id for t in node.targets
                      if isinstance(t, ast.Name) and not t.id.startswith("_")]
    return names


def _has(module, name: str) -> bool:
    obj = module
    for part in name.split("."):
        if dataclasses.is_dataclass(obj) and part in {
                f.name for f in dataclasses.fields(obj)}:
            return True
        if part in getattr(obj, "_fields", ()):
            return True
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_every_public_name_of_the_reference_is_ported():
    """Each public name of every rpg_svo_tpu/ file exists in its port
    file, but for the list above.  A compiled alias (``x_jit = jax.jit(x)``)
    counts as the function it compiles; a donating one does not."""
    missing = []
    for path in sorted((ROOT / "rpg_svo_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "rpg_svo_tpu").as_posix()
        if rel.startswith(NOT_PORTED_FILES):
            continue
        mod = importlib.import_module(
            "rpg_svo_tpu_torch." + rel[:-3].replace("/", "."))
        missing += [f"{rel}:{n}" for n in _public_names(path)
                    if n not in NOT_PORTED.get(rel, ()) and not _has(mod, n)]
    assert not missing, missing


# --- the handler with the bilinear schedule on the main path ----------------
HANDLER_KW = dict(FULL_KW, max_n_kfs=6, max_kfs_pool=8, subpix_n_iter=15)
HANDLER_FRAMES = 8
SCHEDULE_LAST = 3


@pytest.fixture(scope="module")
def schedule_run():
    """The JAX FrameHandler (fast) from ground-truth depth over 8 frames
    of the whole-step scene with SVO_BICUBIC_LAST = 3 (7 bilinear
    iterations of 10), a copy of its state before every frame.  The jit
    caches are cleared around it: the traces read the patched constant."""
    import copy
    ds = SyntheticDataset(**FULL_SCENE)
    jcfg = jconfig.fast_preset(**HANDLER_KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfa, "BICUBIC_LAST", SCHEDULE_LAST)
        jax.clear_caches()
        fh = JFrameHandler(ds.cam, jcfg, img_shape=SHAPE)
        img0, depth0, T0 = ds.frame(0)
        fh.set_first_frame_with_depth(img0, T0.inverse(), depth0)
        imgs = [np.array(ds.frame(i)[0]) for i in range(HANDLER_FRAMES + 1)]
        infos, t_wc, before = [], [], []
        for i in range(1, HANDLER_FRAMES + 1):
            h = copy.copy(fh)
            h.initializer = copy.copy(fh.initializer)
            before.append(h)
            infos.append(fh.add_image(jnp.asarray(imgs[i]), i / 50.0))
            t_wc.append(np.asarray(fh.last_frame.T_f_w.inverse().t))
    jax.clear_caches()
    return dict(infos=infos, t_wc=t_wc, before=before, imgs=imgs,
                T0=T0, img0=np.array(img0), depth0=np.array(depth0),
                tcfg=tconfig.fast_preset(**HANDLER_KW),
                cam=reference_test_camera(SHAPE[1], SHAPE[0]))


def test_handler_with_bilinear_schedule_matches_jax(schedule_run,
                                                    monkeypatch):
    """The port's handler from ground-truth depth with the same schedule:
    per frame the same result and keyframe, t_wc within 1e-3 m; the JAX
    run inserts a keyframe and fails no frame."""
    monkeypatch.setattr(tfa, "BICUBIC_LAST", SCHEDULE_LAST)
    r = schedule_run
    assert any(i.get("is_keyframe") for i in r["infos"])
    assert all(i["result"] != "failure" for i in r["infos"])
    fh = FrameHandler(r["cam"], r["tcfg"], img_shape=SHAPE, device="cpu")
    fh.set_first_frame_with_depth(r["img0"], TSE3(T(r["T0"].R),
                                                  T(r["T0"].t)).inverse(),
                                  r["depth0"])
    for i in range(1, HANDLER_FRAMES + 1):
        info = fh.add_image(r["imgs"][i], i / 50.0)
        ji = r["infos"][i - 1]
        assert (info["result"], info.get("is_keyframe")) \
            == (ji["result"], ji.get("is_keyframe")), i
        close(fh.last_frame.T_f_w.inverse().t.numpy(), r["t_wc"][i - 1],
              f"t_wc {i}", 1e-3)


@pytest.mark.parametrize("frame", [2, 3])
def test_handler_step_with_bilinear_schedule_matches_jax(schedule_run,
                                                         monkeypatch, frame):
    """One add_image from the converted JAX state before an ordinary frame
    (2) and a keyframe (3): the same result, matches and t_wc to 1e-5."""
    monkeypatch.setattr(tfa, "BICUBIC_LAST", SCHEDULE_LAST)
    r = schedule_run
    fh = handler_from_numpy(jax_handler_tree(r["before"][frame - 1]),
                            r["cam"], r["tcfg"], SHAPE, device="cpu")
    info = fh.add_image(r["imgs"][frame], frame / 50.0)
    ji = r["infos"][frame - 1]
    for k in ("result", "is_keyframe", "repr_n_new_references",
              "repr_n_mps", "img_align_n_tracked"):
        assert info.get(k) == ji.get(k), k
    close(fh.last_frame.T_f_w.inverse().t.numpy(), r["t_wc"][frame - 1],
          "t_wc", 1e-5)
