"""The port's tracking step and first-frame seeding against the JAX package,
plus the port's package rules (config copy, no JAX, device defaults).

The slice-A tests run both packages with ablate=("kf", "df") from the JAX
FrameHandler's seeding; the whole-step tests (ablate=(), the `full`
fixture) run the JAX step from the port's seeding converted to JAX, and
start the port from JAX states (core/convert.state_from_numpy); both get
the same numpy images.
Tolerances: poses and point positions to 1e-5 m after one step and 1e-4 m
after three, pixel coordinates to 1e-6 and 1e-5 relative (float32 sums in
another order, compounded over GN solves);
every discrete result (matches, ids, flags, counters) exactly; in the
whole step, seed posteriors and seed-born points to 1e-3 relative (see
DEPTH_RTOL).  The last
row of each pool is left out: it is the pools' scratch row, which no
reader sees; JAX writes disabled inserts and unallocated rows there, the
port writes nothing."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_svo_tpu import config as jconfig
from rpg_svo_tpu.core import fused as jfused
from rpg_svo_tpu.core.pipeline import FrameHandler
from rpg_svo_tpu.ops.detector import detect_features as jdetect
from rpg_svo_tpu.ops.pyramid import build_pyramid as jbuild
from rpg_svo_tpu.utils.synthetic import SyntheticDataset as JDataset
from rpg_svo_tpu.utils.synthetic import render_frame as jrender
from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch import resolve_device
from rpg_svo_tpu_torch.core import fused as tfused
from rpg_svo_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3
from rpg_svo_tpu_torch.ops.detector import detect_features as tdetect
from rpg_svo_tpu_torch.utils import synthetic as tsyn

from _torch_port import (CFG_KW, FULL_FRAMES, SHAPE, jax_tree, run_full,
                         to_torch)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def run():
    ds = JDataset(n_frames=36, trajectory="circle", radius=0.25,
                  revolutions=0.45, shape=SHAPE)
    jcfg = jconfig.fast_preset(**CFG_KW)
    tcfg = tconfig.fast_preset(**CFG_KW)
    fh = FrameHandler(ds.cam, jcfg, img_shape=SHAPE)
    img0, depth0, T0 = ds.frame(0)
    fh.set_first_frame_with_depth(img0, T0.inverse(), depth0)
    js0 = jfused.state_from_handler(fh)
    imgs = [np.asarray(ds.frame(i)[0]) for i in range(1, 5)]
    jstates, jouts = [js0], []
    for img in imgs[:3]:
        js, jo = jfused.vo_step(jstates[-1], jnp.asarray(img), ds.cam, jcfg,
                                fh.ncx, fh.ncy, SHAPE)
        jstates.append(js)
        jouts.append(jo)
    return dict(ds=ds, jcfg=jcfg, tcfg=tcfg, fh=fh, img0=np.asarray(img0),
                depth0=np.asarray(depth0), T0=T0, imgs=imgs,
                jstates=jstates, jouts=jouts,
                cam=tsyn.reference_test_camera(SHAPE[1], SHAPE[0]))


def _close(a, b, name, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        # pixel-scale values (hundreds) get the same few ulps
        np.testing.assert_allclose(a, b, atol=atol, rtol=atol / 10,
                                   err_msg=name)


def _compare_states(t, j, atol):
    """Every field the tracking slice reads or writes."""
    for k in ("R", "t", "frame_id", "feat_px", "feat_f", "feat_level",
              "feat_point", "feat_valid", "stage", "num_obs_last",
              "scrub_pending"):
        _close(t[k], j[k], k, atol)
    _close(t["pad"]["stack"], j["pad"]["stack"], "pad", 1e-4)
    for k in ("pos", "ptype", "n_succ", "n_fail", "last_optim", "obs_kf",
              "obs_feat", "obs_valid", "orig_kf", "orig_px", "orig_f",
              "orig_level", "orig_tile_xy0"):
        _close(t["m"]["pt"][k][:-1], j["m"]["pt"][k][:-1], "pt." + k, atol)
    for k in ("R", "t", "frame_id", "active", "feat_px", "feat_f",
              "feat_level", "feat_point", "feat_valid", "feat_tile_xy0",
              "kp5_dir", "kp5_depth", "kp5_valid"):
        _close(t["m"]["kf"][k][:-1], j["m"]["kf"][k][:-1], "kf." + k, atol)


# seed posteriors and the positions of points born from seeds: 1e-3
# relative (tests/test_torch_depth_filter.py: the triangulation's
# conditioning), i.e. 2e-3 m in the ~2 m scene
DEPTH_RTOL = 1e-3
SEED_POSTERIOR = ("mu", "sigma2", "a", "b")


def _compare_seeds(t, j, atol):
    """The seed pool and the keyframe counter; tiles (pyramid pixels, the
    levels' 2x2 means) to 1e-4, as the keyframe pyramids."""
    for k, w in j["m"]["seed"].items():
        if k in SEED_POSTERIOR:
            _close_rel(t["m"]["seed"][k][:-1], w[:-1], "seed." + k)
        elif k == "tile":
            _close(t["m"]["seed"][k][:-1], w[:-1], "seed.tile", 1e-4)
        else:
            _close(t["m"]["seed"][k][:-1], w[:-1], "seed." + k, atol)
    _close(t["m"]["kf_counter"], j["m"]["kf_counter"], "kf_counter", 0)


def _close_rel(a, b, name):
    np.testing.assert_allclose(a, b, rtol=DEPTH_RTOL, atol=1e-6,
                               err_msg=name)


def _compare_full(t, j, atol):
    """Every field of the whole step: _compare_states with the positions
    of seed-born points (CANDIDATE or promoted UNKNOWN) to 1e-3 of the
    scene depth, plus the seed pool, the keyframe counter and the
    keyframe feature tiles."""
    born = np.isin(j["m"]["pt"]["ptype"], (1, 2))
    t = {**t, "m": {**t["m"], "pt": dict(t["m"]["pt"])}}
    np.testing.assert_allclose(t["m"]["pt"]["pos"][born],
                               j["m"]["pt"]["pos"][born],
                               atol=DEPTH_RTOL * 2.0, err_msg="seed-born pos")
    t["m"]["pt"]["pos"] = np.where(born[:, None], j["m"]["pt"]["pos"],
                                   t["m"]["pt"]["pos"])
    _compare_states(t, j, atol)
    _compare_seeds(t, j, atol)
    for k in ("feat_type", "feat_grad", "feat_tile"):
        _close(t["m"]["kf"][k][:-1], j["m"]["kf"][k][:-1], "kf." + k, 1e-4)


def _outs_equal(to, jo, atol):
    for k in ("n_matches", "n_edges", "is_keyframe", "failed", "stage"):
        assert int(getattr(to, k)) == int(getattr(jo, k)), k
    _close(to.t_wc.numpy(), jo.t_wc, "t_wc", atol)
    _close(to.R_fw.numpy(), jo.R_fw, "R_fw", atol)


def test_config_copy_matches_the_original():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.Config)}
    assert tf == jf
    for name in ("fast_preset", "accurate_preset"):
        assert dataclasses.asdict(getattr(tconfig, name)(max_fts=77)) == \
            dataclasses.asdict(getattr(jconfig, name)(max_fts=77))
    assert tconfig.Config().n_levels_total == jconfig.Config().n_levels_total


@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_bench_cfg_matches_bench_make_cfg(preset, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(JAX_PLATFORMS="cpu", JAX_CACHE_DIR=str(tmp_path))
    code = ("import dataclasses, json, bench; print(json.dumps("
            f"dataclasses.asdict(bench.make_cfg({preset!r}))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = json.loads(json.dumps(dataclasses.asdict(
        tconfig.bench_cfg(preset))))
    assert got == want


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "import rpg_svo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rpg_svo_tpu' or m.startswith('rpg_svo_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stdout + out.stderr
    # and no source names them
    sources = list((ROOT / "rpg_svo_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    for path in sources:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), path
            assert not s.startswith(("import rpg_svo_tpu ",
                                     "from rpg_svo_tpu.")), path


def test_seed_matches_frame_handler(run):
    """seed_first_frame_with_depth against FrameHandler's seeding on every
    field the step reads, the seed pool and the keyframe counter included
    (every cell with a corner gets a point here, so no seed)."""
    r = run
    Tfw = r["T0"].inverse()
    st = tfused.seed_first_frame_with_depth(
        to_torch(r["img0"]), TSE3(to_torch(Tfw.R), to_torch(Tfw.t)),
        to_torch(r["depth0"]), r["cam"], r["tcfg"], img_shape=SHAPE,
        device="cpu")
    t = state_to_numpy(st)
    j = jax_tree(r["jstates"][0])
    # point 0 (allocated when cell 0 holds a detection) keeps its
    # observation in the port; the JAX seeding loses it (ROADMAP.md)
    if j["m"]["pt"]["orig_kf"][0] >= 0:
        assert t["m"]["pt"]["obs_valid"][0, 0]
        for k in ("obs_kf", "obs_feat", "obs_valid"):
            t["m"]["pt"][k][0] = j["m"]["pt"][k][0]
    _compare_states(t, j, 1e-5)
    _close(t["m"]["kf"]["flat_pyr"][:-1], j["m"]["kf"]["flat_pyr"][:-1],
           "flat_pyr", 1e-4)
    _close(t["m"]["kf"]["feat_tile"][:-1], j["m"]["kf"]["feat_tile"][:-1],
           "feat_tile", 1e-4)
    _close(t["m"]["pt"]["orig_tile"][:-1], j["m"]["pt"]["orig_tile"][:-1],
           "orig_tile", 1e-4)
    _compare_seeds(t, j, 1e-6)
    assert not t["m"]["seed"]["active"].any()


def test_detector_matches_jax(run):
    pyr = jbuild(jnp.asarray(run["img0"]), 3)
    C = run["fh"].n_cells
    dj = jdetect(pyr, jnp.zeros((C,), bool), 12)
    dt = tdetect([to_torch(np.asarray(l)) for l in pyr],
                 torch.zeros(C, dtype=torch.bool), 12)
    for k in ("px", "level", "valid"):
        _close(dt[k].numpy(), dj[k], k, 0)
    # scores: float64 integral images here, float32 ones in JAX
    _close(dt["score"].numpy(), dj["score"], "score", 0.5)


def test_one_step_matches_jax(run):
    r = run
    ts = state_from_numpy(jax_tree(r["jstates"][0]), device="cpu")
    ts, to = tfused.vo_step(ts, to_torch(r["imgs"][0]), r["cam"], r["tcfg"],
                            r["fh"].ncx, r["fh"].ncy, SHAPE)
    _outs_equal(to, r["jouts"][0], 1e-5)
    assert not bool(to.failed) and int(to.n_matches) >= 50
    _compare_states(state_to_numpy(ts), jax_tree(r["jstates"][1]), 1e-5)


def test_three_steps_match_jax(run):
    r = run
    ts = state_from_numpy(jax_tree(r["jstates"][0]), device="cpu")
    for i in range(3):
        ts, to = tfused.vo_step(ts, to_torch(r["imgs"][i]), r["cam"],
                                r["tcfg"], r["fh"].ncx, r["fh"].ncy, SHAPE)
        _outs_equal(to, r["jouts"][i], 1e-4)
    _compare_states(state_to_numpy(ts), jax_tree(r["jstates"][3]), 1e-4)


def test_black_frame_relocalizes_like_jax(run):
    """A black frame fails; the next step aligns against the closest
    keyframe (the relocalization branch) and recovers, as in JAX."""
    r = run
    ts = state_from_numpy(jax_tree(r["jstates"][1]), device="cpu")
    js = r["jstates"][1]
    black = np.zeros(SHAPE, np.float32)
    for img in (black, r["imgs"][1]):
        js, jo = jfused.vo_step(js, jnp.asarray(img), r["ds"].cam,
                                r["jcfg"], r["fh"].ncx, r["fh"].ncy, SHAPE)
        ts, to = tfused.vo_step(ts, to_torch(img), r["cam"], r["tcfg"],
                                r["fh"].ncx, r["fh"].ncy, SHAPE)
        _outs_equal(to, jo, 1e-4)
    assert not bool(to.failed) and int(to.stage) == tfused.STAGE_DEFAULT


def test_port_tracks_from_its_own_seed(run):
    """The port alone, from the raw first image: no failed frame, error
    against ground truth within 5 mm; vo_scan equals the step loop."""
    r = run
    Tfw = r["T0"].inverse()
    st0 = tfused.seed_first_frame_with_depth(
        to_torch(r["img0"]), TSE3(to_torch(Tfw.R), to_torch(Tfw.t)),
        to_torch(r["depth0"]), r["cam"], r["tcfg"], img_shape=SHAPE,
        device="cpu")
    imgs = [to_torch(i) for i in r["imgs"]]
    st, outs = tfused.vo_scan(st0, imgs, r["cam"], r["tcfg"], r["fh"].ncx,
                              r["fh"].ncy, SHAPE)
    s2 = st0
    for i, img in enumerate(imgs):
        s2, o2 = tfused.vo_step(s2, img, r["cam"], r["tcfg"], r["fh"].ncx,
                                r["fh"].ncy, SHAPE)
        assert torch.equal(o2.t_wc, outs.t_wc[i])
    for i in range(len(imgs)):
        assert not bool(outs.failed[i])
        gt = np.asarray(r["ds"].poses[i + 1].t)
        assert np.linalg.norm(outs.t_wc[i].numpy() - gt) < 5e-3


def test_step_rejects_an_unknown_ablation(run):
    """Every stage JAX may ablate is tests/test_torch_ablate.py's; a name
    that is no stage raises, with or beside the known ones."""
    r = run
    ts = state_from_numpy(jax_tree(r["jstates"][0]), device="cpu")
    cfg = r["tcfg"].replace(ablate=("kf", "pyramid"))
    with pytest.raises(NotImplementedError, match="pyramid"):
        tfused.vo_step(ts, to_torch(r["imgs"][0]), r["cam"], cfg,
                       r["fh"].ncx, r["fh"].ncy, SHAPE)


def test_entry_points_run_on_cuda_unless_told_otherwise(run):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        tsyn.SyntheticDataset(n_frames=2, shape=SHAPE)
    with pytest.raises(RuntimeError):
        state_from_numpy(jax_tree(run["jstates"][0]))
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("i", [0, 17])
def test_renderer_matches_jax(run, i):
    """Texture sums of 48 sinusoids in float32 with other libm sin: 0.01
    of 255 for the image; depth and poses to float32 rounding."""
    ds = run["ds"]
    tds = tsyn.SyntheticDataset(n_frames=36, trajectory="circle",
                                radius=0.25, revolutions=0.45, shape=SHAPE,
                                device="cpu")
    np.testing.assert_allclose(tds.poses[i].R.numpy(),
                               np.asarray(ds.poses[i].R), atol=1e-6)
    np.testing.assert_allclose(tds.poses[i].t.numpy(),
                               np.asarray(ds.poses[i].t), atol=1e-6)
    img_t, dep_t, _ = tds.frame(i)
    img_j, dep_j = jrender(ds.cam, ds.tex, ds.poses[i], SHAPE)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-2)
    np.testing.assert_allclose(dep_t.numpy(), np.asarray(dep_j), rtol=1e-5)


def test_seed_with_depth_holes_matches_frame_handler(run):
    """Cells without ground-truth depth get no point, so the seeding's
    depth-filter init seeds them: the seed pool against FrameHandler's."""
    r = run
    depth = r["depth0"].copy()
    depth[:, : SHAPE[1] // 3] = 0.0
    fh = FrameHandler(r["ds"].cam, r["jcfg"], img_shape=SHAPE)
    fh.set_first_frame_with_depth(jnp.asarray(r["img0"]), r["T0"].inverse(),
                                  jnp.asarray(depth))
    j = jax_tree(jfused.state_from_handler(fh))
    Tfw = r["T0"].inverse()
    st = tfused.seed_first_frame_with_depth(
        to_torch(r["img0"]), TSE3(to_torch(Tfw.R), to_torch(Tfw.t)),
        to_torch(depth), r["cam"], r["tcfg"], img_shape=SHAPE, device="cpu")
    t = state_to_numpy(st)
    assert j["m"]["seed"]["active"].sum() > 20
    _compare_seeds(t, j, 1e-6)
    # the seeds' depth prior comes from the points alone: exact here
    for k in SEED_POSTERIOR:
        _close(t["m"]["seed"][k][:-1], j["m"]["seed"][k][:-1], "seed." + k,
               1e-6)


@pytest.fixture(scope="module")
def full():
    return run_full("fast", FULL_FRAMES)


def _full_steps(r, start, n):
    """The port from JAX state `start` over n frames (state 0 is the
    port's own seeding, converted); returns (state, outs)."""
    ts = state_from_numpy(jax_tree(r["states"][start]), device="cpu")
    outs = []
    for i in range(start, start + n):
        ts, to = tfused.vo_step(ts, to_torch(r["imgs"][i]), r["cam"],
                                r["tcfg"], r["fh"].ncx, r["fh"].ncy, SHAPE)
        outs.append(to)
    return ts, outs


def test_full_scene_exercises_every_stage(full):
    """The JAX run these tests hold the port to inserts keyframes, updates
    seeds, converts seeds into candidates and lets the map cap delete
    keyframes; so none of the whole-step tests is vacuous."""
    st, outs = full["states"], full["outs"]
    kfs = [i + 1 for i, o in enumerate(outs) if bool(o.is_keyframe)]
    assert len(kfs) >= 4
    n_kf = [int(s.m.kf.active.sum()) for s in st]
    capped = [i for i in kfs if n_kf[i] == n_kf[i - 1]]
    assert capped, "the map cap never deleted a keyframe"
    served = [i for i in range(1, len(st)) if (np.asarray(
        st[i].m.seed.upd_count) > np.asarray(st[i - 1].m.seed.upd_count)).any()]
    assert len(served) >= 5
    cand = [int((np.asarray(s.m.pt.ptype) == 1).sum()) for s in st]
    assert max(cand) > 10
    # the steps the tests below start from
    assert 6 in kfs and 14 in capped and int(st[5].m.seed.active.sum()) > 100


def test_one_full_step_matches_jax(full):
    """Frame 6 from the JAX state after frame 5 (live seeds): a keyframe
    with a seed update, insertion, binding, seed detection and init."""
    ts, (to,) = _full_steps(full, 5, 1)
    _outs_equal(to, full["outs"][5], 1e-5)
    assert bool(to.is_keyframe)
    _compare_full(state_to_numpy(ts), jax_tree(full["states"][6]), 1e-5)


def test_three_full_steps_match_jax(full):
    ts, outs = _full_steps(full, 5, 3)
    for to, jo in zip(outs, full["outs"][5:8]):
        _outs_equal(to, jo, 1e-4)
    _compare_full(state_to_numpy(ts), jax_tree(full["states"][8]), 1e-4)


def test_keyframe_step_with_the_map_cap_matches_jax(full):
    """Frame 14: a keyframe past max_n_kfs, so the furthest keyframe (not
    the new one) is deleted with its seeds and starved points."""
    ts, (to,) = _full_steps(full, 13, 1)
    _outs_equal(to, full["outs"][13], 1e-4)
    t, j = state_to_numpy(ts), jax_tree(full["states"][14])
    _compare_full(t, j, 1e-4)
    before = jax_tree(full["states"][13])["m"]["kf"]["active"]
    assert (before & ~t["m"]["kf"]["active"]).sum() == 1


def test_vo_scan_stacks_outputs_like_jax(full):
    """vo_scan returns one StepOut with every field stacked along T, as
    JAX's lax.scan does: over the whole-step scene's frames from the same
    state, the same fields, shapes and dtypes, t_wc within 1e-4 m and the
    same keyframes."""
    imgs = np.stack(full["imgs"])
    _, jo = jfused.vo_scan(full["states"][0], jnp.asarray(imgs),
                           full["ds"].cam, full["jcfg"], full["fh"].ncx,
                           full["fh"].ncy, SHAPE)
    ts = state_from_numpy(jax_tree(full["states"][0]), device="cpu")
    _, to = tfused.vo_scan(ts, to_torch(imgs), full["cam"], full["tcfg"],
                           full["fh"].ncx, full["fh"].ncy, SHAPE)
    assert isinstance(to, tfused.StepOut)
    assert to._fields == jfused.StepOut._fields
    for k in to._fields:
        a, b = getattr(to, k).numpy(), np.asarray(getattr(jo, k))
        assert a.shape == b.shape and a.shape[0] == FULL_FRAMES, k
        assert a.dtype == b.dtype, k
    np.testing.assert_array_equal(to.is_keyframe.numpy(),
                                  np.asarray(jo.is_keyframe))
    assert to.is_keyframe.any() and not to.failed.any()
    np.testing.assert_allclose(to.t_wc.numpy(), np.asarray(jo.t_wc),
                               atol=1e-4, rtol=0)


def test_full_trajectory_matches_jax(full):
    """All 18 frames from the JAX seeding: the same keyframe frames and
    t_wc within 1e-3 m (measured 1.6e-5)."""
    _, outs = _full_steps(full, 0, FULL_FRAMES)
    jo = full["outs"]
    assert [bool(o.is_keyframe) for o in outs] == \
        [bool(o.is_keyframe) for o in jo]
    assert not any(bool(o.failed) for o in outs)
    dt = max(float(np.abs(o.t_wc.numpy() - np.asarray(j.t_wc)).max())
             for o, j in zip(outs, jo))
    assert dt < 1e-3, dt
