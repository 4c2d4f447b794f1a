"""The port's host pipeline (core/pipeline.FrameHandler) against the JAX
package's on the CPU: the whole handler from ground-truth depth in the
fast preset, single steps from converted JAX handler states (a keyframe
with the map cap, a seed update, an accurate keyframe with local BA),
relocalization after a blank frame and at a given pose, global BA,
transform_map, the raw-image sparse alignment, the accessors and
state_from_handler.

The scene is the whole-step scene of tests/_torch_port.py with a
6-keyframe cap in an 8-slot pool (HANDLER_KW): over
20 frames the JAX handler inserts keyframes at frames 3, 6, 10, 14 and 18
(the last one over the cap), updates seeds on every even frame and
converts seeds into candidate points.  Tolerances: every discrete result
exactly; t_wc to 1e-3 m over the whole run (measured below 2e-5); one step
from a converted state to 1e-5 (local BA and seed-born values as in
tests/test_torch_local_ba.py).  The last row of each pool is left out:
JAX writes disabled inserts there, the port nothing."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_svo_tpu import config as jconfig
from rpg_svo_tpu.core import fused as jfused
from rpg_svo_tpu.core import map as jmap
from rpg_svo_tpu.core import pipeline as jpipe
from rpg_svo_tpu.core.pipeline import FrameHandler as JFrameHandler
from rpg_svo_tpu.geometry.se3 import SE3 as JSE3
from rpg_svo_tpu.ops.sparse_align import sparse_img_align as jalign
from rpg_svo_tpu.utils.synthetic import SyntheticDataset
from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch.core import fused as tfused
from rpg_svo_tpu_torch.core import map as tmap
from rpg_svo_tpu_torch.core import spans
from rpg_svo_tpu_torch.core.convert import (
    handler_from_numpy, handler_to_numpy, map_from_numpy, state_to_numpy)
from rpg_svo_tpu_torch.core.pipeline import FrameHandler
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3
from rpg_svo_tpu_torch.ops.sparse_align import sparse_img_align_raw
from rpg_svo_tpu_torch.utils.synthetic import reference_test_camera

from _torch_port import (FULL_KW, FULL_SCENE, SHAPE, close, jax_handler_tree,
                         jax_tree)

HANDLER_KW = dict(FULL_KW, max_n_kfs=6, max_kfs_pool=8)
N_FRAMES = 20
SEED_POSTERIOR = ("mu", "sigma2", "a", "b")
TRACE_NAMES = ("pyramid_creation", "sparse_img_align", "reproject_kfs",
               "reproject_candidates", "feature_align", "reproject",
               "pose_optimizer", "point_optimizer")


def T(a):
    return torch.from_numpy(np.array(a))


def _snapshot(fh):
    """A JAX FrameHandler that add_image on the original leaves as it is."""
    h = copy.copy(fh)
    h.initializer = copy.copy(fh.initializer)
    h.log = []
    return h


def _t_wc(fh):
    return np.asarray(fh.last_frame.T_f_w.inverse().t)


def _jax_run(preset, n_frames, stop_at_keyframe=False):
    ds = SyntheticDataset(**FULL_SCENE)
    jcfg = getattr(jconfig, f"{preset}_preset")(**HANDLER_KW)
    fh = JFrameHandler(ds.cam, jcfg, img_shape=SHAPE)
    img0, depth0, T0 = ds.frame(0)
    fh.set_first_frame_with_depth(img0, T0.inverse(), depth0)
    imgs = [np.asarray(ds.frame(i)[0]) for i in range(n_frames + 1)]
    infos, t_wc, before = [], [], []
    for i in range(1, n_frames + 1):
        before.append(_snapshot(fh))
        infos.append(fh.add_image(jnp.asarray(imgs[i]), i / 50.0))
        t_wc.append(_t_wc(fh))
        if stop_at_keyframe and infos[-1].get("is_keyframe"):
            break
    return dict(ds=ds, jcfg=jcfg, fh=fh,
                tcfg=getattr(tconfig, f"{preset}_preset")(**HANDLER_KW),
                T0=T0, img0=np.asarray(img0), depth0=np.asarray(depth0),
                imgs=imgs, infos=infos, t_wc=t_wc, before=before,
                cam=reference_test_camera(SHAPE[1], SHAPE[0]))


@pytest.fixture(scope="module")
def hrun():
    """The JAX FrameHandler, fast preset, from ground-truth depth over 20
    frames, with a snapshot of the handler before every frame."""
    return _jax_run("fast", N_FRAMES)


def _port(r, i):
    """The port's handler in the JAX state before frame i."""
    return handler_from_numpy(jax_handler_tree(r["before"][i - 1]), r["cam"],
                              r["tcfg"], SHAPE, device="cpu")


def _compare_maps(t, j, atol, skip_point0_obs=False):
    """Every pool field but the scratch rows: seed posteriors 1e-3
    relative (the triangulation's conditioning, see
    tests/test_torch_depth_filter.py), the positions of seed-born points
    (CANDIDATE, UNKNOWN) to 2e-3 m, tiles and pyramids to 1e-4."""
    born = np.isin(j["pt"]["ptype"], (1, 2))
    t = {k: dict(v) if isinstance(v, dict) else v for k, v in t.items()}
    np.testing.assert_allclose(t["pt"]["pos"][born], j["pt"]["pos"][born],
                               atol=2e-3, err_msg="seed-born pos")
    t["pt"]["pos"] = np.where(born[:, None], j["pt"]["pos"], t["pt"]["pos"])
    if skip_point0_obs:
        for k in ("obs_kf", "obs_feat", "obs_valid"):
            t["pt"][k] = t["pt"][k].copy()
            t["pt"][k][0] = j["pt"][k][0]
    for store in ("kf", "pt", "seed"):
        for k, w in j[store].items():
            if store == "seed" and k in SEED_POSTERIOR:
                np.testing.assert_allclose(t[store][k][:-1], w[:-1],
                                           rtol=1e-3, atol=1e-6,
                                           err_msg="seed." + k)
            elif k in ("flat_pyr", "feat_tile", "orig_tile", "tile"):
                close(t[store][k][:-1], w[:-1], f"{store}.{k}", 1e-4)
            else:
                close(t[store][k][:-1], w[:-1], f"{store}.{k}", atol)
    close(t["kf_counter"], j["kf_counter"], "kf_counter", 0)


def _compare_handlers(tfh, jfh, atol, skip_point0_obs=False,
                      pos_from_jax=False):
    """Maps, stage machines and last frames; pos_from_jax when the
    caller held the point positions to its own tolerance."""
    t, j = handler_to_numpy(tfh), jax_handler_tree(jfh)
    if pos_from_jax:
        t["map"]["pt"]["pos"] = j["map"]["pt"]["pos"]
    _compare_maps(t["map"], j["map"], atol, skip_point0_obs)
    for k in ("stage", "quality", "num_obs_last", "next_id"):
        assert t[k] == j[k], k
    tl, jl = t["last_frame"], j["last_frame"]
    for k in ("R", "t", "frame_id", "feat_px", "feat_f", "feat_level",
              "feat_point", "feat_valid", "feat_type", "feat_grad"):
        close(tl[k], jl[k], "last_frame." + k, atol)
    close(tl["pad"]["stack"], jl["pad"]["stack"], "last_frame.pad", 1e-4)


def _infos_equal(ti, ji):
    for k in ("result", "stage", "frame_id", "is_keyframe",
              "repr_n_new_references", "repr_n_mps", "img_align_n_tracked",
              "sfba_n_edges_final", "n_seeds", "init_inliers"):
        assert ti.get(k) == ji.get(k), (ji.get("frame_id"), k)


def test_the_jax_run_exercises_every_stage(hrun):
    """Keyframes (one over the cap), seed updates and seed conversions in
    the JAX run, and no failure: the tests below are not vacuous."""
    infos = hrun["infos"]
    kfs = [i["frame_id"] for i in infos if i.get("is_keyframe")]
    assert kfs == [3, 6, 10, 14, 18], kfs
    assert all(i["result"] != "failure" for i in infos)
    assert sum("n_seeds" in i for i in infos) >= 10
    m = hrun["fh"].map
    assert int((np.asarray(m.pt.ptype) == jmap.TYPE_CANDIDATE).sum()) \
        + int((np.asarray(m.pt.ptype) == jmap.TYPE_UNKNOWN).sum()) > 10
    # after frame 17: 5 keyframes; frame 18 inserts the sixth and, at the
    # cap, deletes the furthest
    n_kf = [int(np.asarray(h.map.kf.active).sum()) for h in hrun["before"]]
    assert n_kf[17] == 5 and n_kf[18] == 5


def test_handler_from_ground_truth_depth_matches_jax(hrun):
    """set_first_frame_with_depth, then 20 frames of add_image: per frame
    the same result, keyframe and reprojection match count, and t_wc
    within 1e-3 m; with spans on (the SVO_TRACE build), every frame's info
    holds the tracking stages' times."""
    r = hrun
    fh = FrameHandler(r["cam"], r["tcfg"], img_shape=SHAPE, device="cpu")
    Tfw = r["T0"].inverse()
    fh.set_first_frame_with_depth(T(r["img0"]), TSE3(T(Tfw.R), T(Tfw.t)),
                                  T(r["depth0"]))
    dt = 0.0
    with spans.recording():
        for i, (ji, jt) in enumerate(zip(r["infos"], r["t_wc"]), start=1):
            ti = fh.add_image(T(r["imgs"][i]), i / 50.0)
            for k in ("result", "is_keyframe", "repr_n_new_references"):
                assert ti.get(k) == ji.get(k), (i, k)
            dt = max(dt, float(np.abs(
                fh.last_frame.T_f_w.inverse().t.numpy() - jt).max()))
            assert set(TRACE_NAMES) <= set(ti), set(TRACE_NAMES) - set(ti)
    assert dt < 1e-3, dt
    assert fh.tracking_quality() == r["fh"].tracking_quality()
    assert fh.last_processing_time() > 0


@pytest.mark.parametrize("frame,pos_tol", [(10, 1e-5), (12, 1e-5),
                                           (18, 1e-4)])
def test_handler_step_from_a_jax_state_matches_jax(hrun, frame, pos_tol):
    """One add_image from the JAX state before it: frame 10 is a keyframe,
    12 updates seeds, 18 is a keyframe past the cap (the furthest
    keyframe dies with its seeds and starved points).  Everything to
    1e-5, but at frame 18 one point's structure refinement (a short
    baseline, five Gauss-Newton steps in float32) to 1e-4 (measured
    2.0e-5).  Point 0's observation table is left out where the reference
    loses an observation at a keyframe (see the next test)."""
    r = hrun
    fh = _port(r, frame)
    ti = fh.add_image(T(r["imgs"][frame]), frame / 50.0)
    _infos_equal(ti, r["infos"][frame - 1])
    jfh = r["before"][frame] if frame < N_FRAMES else r["fh"]
    t, j = handler_to_numpy(fh), jax_handler_tree(jfh)
    close(t["map"]["pt"]["pos"][:-1], j["map"]["pt"]["pos"][:-1], "pt.pos",
          pos_tol)
    _compare_handlers(fh, jfh, 1e-5, skip_point0_obs=True, pos_from_jax=True)


def test_keyframe_binds_point_0_where_the_reference_loses_it(hrun):
    """Reference fault at rpg_svo_tpu/core/pipeline.py:539-545: at a
    keyframe, add_point_observations and the `hit` scatter run over all F
    feature rows, and rows without a point clip their id -1 to point 0,
    so the clipped scatters write point 0's old values back over its new
    observation.  In this scene point 0 (cell 0's seeded corner) leaves
    the view early, so before keyframe 10 it is made a copy of a point
    that keyframe matches (the original deleted, references moved to 0),
    and all but 100 other points are deleted so that some feature rows
    hold no point, in both packages.  JAX's point 0 keeps only the
    observations it had; the port's gains one on the new keyframe; the
    rest agrees."""
    r = hrun
    i = 10
    jfh = _snapshot(r["before"][i - 1])
    m = jfh.map
    lf = r["before"][i].last_frame
    # a point matched at keyframe 10 that is alone in its grid cell (the
    # cell's pick prefers the highest index within a point type)
    px = np.asarray(lf.T_f_w.apply(m.pt.pos))
    cell = (np.floor(px[:, 1] / px[:, 2] * r["ds"].cam.fy + r["ds"].cam.cy)
            // 12) * 1000 + np.floor(px[:, 0] / px[:, 2] * r["ds"].cam.fx
                                      + r["ds"].cam.cx) // 12
    alive = np.asarray(m.pt.ptype) > 0
    fp = np.asarray(lf.feat_point)[np.asarray(lf.feat_valid)]
    src = next(int(p) for p in fp if p > 0
               and (alive & (cell == cell[p])).sum() == 1)
    pt = m.pt._replace(**{k: getattr(m.pt, k).at[0].set(
        getattr(m.pt, k)[src]) for k in m.pt._fields})
    # only 100 other points stay, so that the keyframe's table has rows
    # without a point
    keep = np.zeros(alive.shape, bool)
    keep[[p for p in fp if p != src][:100]] = True
    keep[0] = True
    pt = pt._replace(ptype=jnp.where(jnp.asarray(keep), pt.ptype,
                                     jmap.TYPE_DELETED))
    moved = lambda fp: jnp.where(fp == src, 0, fp)  # noqa: E731
    jfh.map = m._replace(pt=pt, kf=m.kf._replace(
        feat_point=moved(m.kf.feat_point)))
    jfh.last_frame = jfh.last_frame._replace(
        feat_point=moved(jfh.last_frame.feat_point))
    tree = jax_handler_tree(jfh)
    ji = jfh.add_image(jnp.asarray(r["imgs"][i]), i / 50.0)
    fh = handler_from_numpy(tree, r["cam"], r["tcfg"], SHAPE, device="cpu")
    ti = fh.add_image(T(r["imgs"][i]), i / 50.0)
    _infos_equal(ti, ji)
    assert ti["is_keyframe"] and ti["repr_n_new_references"] < fh.feat_cap
    lf = fh.last_frame
    assert 0 in lf.feat_point[lf.feat_valid].tolist()
    j, t = jax_tree(jfh.map), handler_to_numpy(fh)["map"]
    slot = int(np.flatnonzero(j["kf"]["frame_id"] == i)[0])
    before = tree["map"]["pt"]["obs_valid"][0]
    np.testing.assert_array_equal(j["pt"]["obs_valid"][0], before)
    new = t["pt"]["obs_valid"][0] & ~before
    assert new.sum() == 1 and t["pt"]["obs_kf"][0][new][0] == slot
    _compare_handlers(fh, jfh, 1e-5, skip_point0_obs=True)


def test_structure_opt_keeps_point_0_against_padded_rows(hrun):
    """Reference fault at rpg_svo_tpu/core/pipeline.py:120-123
    (_structure_opt): with fewer valid features than points to refine,
    the padded selection rows clip to point 0, and the scatters pos.at[sel]
    and last_optim.at[sel] keep their last writer, so a refined point 0 is
    written back with its stale values.  Here a frame holds 5 features,
    point 0 among them: JAX leaves point 0 unrefined, the port refines
    it; the other four agree."""
    r = hrun
    jfh = r["before"][10]
    m, lf = jfh.map, jfh.last_frame
    fp = np.asarray(lf.feat_point)
    n_obs = np.asarray(m.pt.obs_valid).sum(1)
    live = np.flatnonzero(np.asarray(lf.feat_valid) & (fp > 0)
                          & (n_obs[np.clip(fp, 0, None)] >= 2))
    # point 0 becomes a copy of the first such point, moved by 1 cm, so
    # that it has the observations to be refined
    src = int(fp[live[0]])
    pt = m.pt._replace(**{k: getattr(m.pt, k).at[0].set(
        getattr(m.pt, k)[src]) for k in m.pt._fields})
    pt = pt._replace(pos=pt.pos.at[0].add(0.01),
                     last_optim=pt.last_optim.at[0].set(-1))
    m = m._replace(pt=pt)
    pts = np.concatenate([[0], fp[live[1:5]]]).astype(np.int32)
    F = fp.shape[0]
    feat_point = np.full(F, -1, np.int32)
    feat_point[:5] = pts
    feat_valid = feat_point >= 0
    jf = lf._replace(feat_point=jnp.asarray(feat_point),
                     feat_valid=jnp.asarray(feat_valid),
                     frame_id=jnp.int32(11))
    want = jax_tree(jpipe._structure_opt(m, jf, 20, 5))
    got = tfused._structure_opt_fused(
        map_from_numpy(jax_tree(m), device="cpu"),
        TSE3(T(lf.R), T(lf.t)), torch.tensor(11, dtype=torch.int32),
        T(feat_point), T(feat_valid), 20, 5, torch.tensor(True))
    assert want["pt"]["last_optim"][0] == -1
    assert int(got.pt.last_optim[0]) == 11
    assert np.abs(got.pt.pos.numpy()[0] - want["pt"]["pos"][0]).max() > 1e-3
    close(got.pt.last_optim.numpy()[pts[1:]], want["pt"]["last_optim"][
        pts[1:]], "last_optim", 0)
    close(got.pt.pos.numpy()[pts[1:]], want["pt"]["pos"][pts[1:]], "pos",
          1e-5)


def test_accurate_keyframe_step_with_local_ba_matches_jax():
    """The accurate preset from ground-truth depth: the first keyframe
    runs local BA in add_image (its span with spans on, the SVO_TRACE
    build); the port from the JAX state before it."""
    r = _jax_run("accurate", 8, stop_at_keyframe=True)
    i = len(r["infos"])
    ji = r["infos"][-1]
    assert ji.get("is_keyframe") and "local_ba" in ji
    fh = _port(r, i)
    with spans.recording():
        ti = fh.add_image(T(r["imgs"][i]), i / 50.0)
    _infos_equal(ti, ji)
    assert "local_ba" in ti
    t, j = handler_to_numpy(fh), jax_handler_tree(r["fh"])
    # local BA's points: 2e-4 m, as tests/test_torch_local_ba.py holds them
    close(t["map"]["pt"]["pos"][:-1], j["map"]["pt"]["pos"][:-1], "pt.pos",
          2e-4, rtol=0)
    t["map"]["pt"]["pos"] = j["map"]["pt"]["pos"]
    _compare_maps(t["map"], j["map"], 1e-4, skip_point0_obs=True)
    close(t["last_frame"]["t"], j["last_frame"]["t"], "t", 1e-4)


def test_blank_frame_then_relocalization_matches_jax(hrun):
    """A black frame fails (the pose stays) and sends the handler into
    relocalization; the next frame (frame 11) aligns the closest
    keyframe's raw levels, tracks from it and returns to the default
    stage.  (The black frame's alignment is ill-posed; at some other start
    frames its pose lands a point on the projection border in one
    package only, which changes that point's miss count by one.)"""
    r = hrun
    jfh = _snapshot(r["before"][10])
    fh = _port(r, 11)
    black = np.zeros(SHAPE, np.float32)
    for img, want in ((black, "relocalizing"), (r["imgs"][11], "default")):
        ji = jfh.add_image(jnp.asarray(img), 0.3)
        ti = fh.add_image(T(img), 0.3)
        _infos_equal(ti, ji)
        assert fh.stage == jfh.stage == want
        close(fh.last_frame.T_f_w.inverse().t.numpy(), _t_wc(jfh), "t_wc",
              1e-5)
    assert ti["result"] != "failure"
    _compare_handlers(fh, jfh, 1e-5, skip_point0_obs=True)


def test_relocalize_frame_at_pose_matches_jax(hrun):
    """relocalizeFrameAtPose against the newest keyframe with the next
    frame's image, as tests/test_map_and_aux.py calls it."""
    r = hrun
    jfh = _snapshot(r["before"][11])
    fh = _port(r, 12)
    kf = jfh.map.kf
    kf_id = int(np.asarray(kf.frame_id)[np.asarray(kf.active)].max())
    img = r["imgs"][kf_id + 1]
    assert jfh.relocalize_frame_at_pose(kf_id, JSE3.identity(),
                                        jnp.asarray(img), 0.9)
    assert fh.relocalize_frame_at_pose(kf_id, TSE3.identity(), T(img), 0.9)
    assert fh.stage == jfh.stage == "default"
    close(fh.last_frame.T_f_w.inverse().t.numpy(), _t_wc(jfh), "t_wc", 1e-5)
    _compare_handlers(fh, jfh, 1e-5, skip_point0_obs=True)
    assert not fh.relocalize_frame_at_pose(12345, TSE3.identity(), T(img))


def test_sparse_img_align_raw_matches_jax(hrun):
    """The raw-image path (level tuples, no padded pyramid) against JAX's:
    frame 12 against keyframe 10's stored levels, features near the
    borders included (per-pixel validity, no clamped tiles)."""
    r = hrun
    m = r["before"][12].map
    slot = int(np.flatnonzero(np.asarray(m.kf.frame_id) == 10)[0])
    kf = m.kf
    fp = np.asarray(kf.feat_point[slot])
    pos = np.asarray(m.pt.pos)[np.clip(fp, 0, None)]
    Tk = JSE3(kf.R[slot], kf.t[slot])
    depth = np.linalg.norm(np.asarray(Tk.apply(jnp.asarray(pos))), axis=-1)
    valid = np.asarray(kf.feat_valid[slot]) & (fp >= 0)
    jfh = r["before"][12]
    from rpg_svo_tpu.ops.pallas_tiles import PaddedPyramid as JPad
    from rpg_svo_tpu.ops.pyramid import build_pyramid, pyramid_shapes
    shapes = pyramid_shapes(SHAPE, 5)
    ref = JPad.from_stack(kf.flat_pyr[slot], shapes).levels()
    cur = build_pyramid(jnp.asarray(r["imgs"][12]), 5)
    args = (kf.feat_px[slot], kf.feat_f[slot], jnp.asarray(depth),
            jnp.asarray(valid))
    want = jalign(tuple(ref), tuple(cur), jfh.cam, JSE3.identity(), *args,
                  max_level=4, min_level=2)
    got = sparse_img_align_raw(
        tuple(T(np.asarray(l)) for l in ref),
        tuple(T(np.asarray(l)) for l in cur), r["cam"], TSE3.identity(),
        *[T(np.asarray(a)) for a in args], max_level=4, min_level=2)
    assert int(got.n_tracked) == int(want.n_tracked) > 30
    close(got.T_cur_ref.R.numpy(), want.T_cur_ref.R, "R", 1e-5)
    close(got.T_cur_ref.t.numpy(), want.T_cur_ref.t, "t", 1e-5)
    close(got.chi2.numpy(), want.chi2, "chi2", 1e-5, rtol=1e-4)


def test_global_ba_matches_jax(hrun):
    """global_ba on the map after 20 frames: every active keyframe and
    every observed point move; stale and outlier observations go."""
    r = hrun
    jfh = _snapshot(r["fh"])
    fh = handler_from_numpy(jax_handler_tree(jfh), r["cam"], r["tcfg"],
                            SHAPE, device="cpu")
    before = jax_tree(jfh.map)
    jfh.global_ba()
    fh.global_ba()
    t, j = handler_to_numpy(fh)["map"], jax_tree(jfh.map)
    close(t["kf"]["R"][:-1], j["kf"]["R"][:-1], "kf.R", 1e-5)
    close(t["kf"]["t"][:-1], j["kf"]["t"][:-1], "kf.t", 1e-5)
    close(t["pt"]["pos"][:-1], j["pt"]["pos"][:-1], "pt.pos", 2e-4, rtol=0)
    for k in ("obs_valid", "feat_valid", "feat_point"):
        store = "pt" if k == "obs_valid" else "kf"
        close(t[store][k][:-1], j[store][k][:-1], f"{store}.{k}", 0)
    assert np.abs(j["pt"]["pos"] - before["pt"]["pos"]).max() > 1e-6


def test_transform_map_matches_jax(hrun):
    m = hrun["before"][12].map
    R = JSE3.exp(jnp.array([0, 0, 0, 0.3, -0.2, 0.5], jnp.float32)).R
    t = jnp.array([1.0, -2.0, 0.5], jnp.float32)
    want = jax_tree(jmap.transform_map(m, R, t, jnp.float32(2.5)))
    got = tmap.transform_map(map_from_numpy(jax_tree(m), device="cpu"),
                             T(R), T(t), 2.5)
    _compare_maps(handler_to_numpy_map(got), want, 2e-5)


def handler_to_numpy_map(m):
    return {k: ({f: v.numpy() for f, v in getattr(m, k)._asdict().items()}
                if k != "kf_counter" else m.kf_counter.numpy())
            for k in ("kf", "pt", "seed", "kf_counter")}


def test_accessors_match_jax(hrun):
    r = hrun
    jfh = r["fh"]
    fh = handler_from_numpy(jax_handler_tree(jfh), r["cam"], r["tcfg"],
                            SHAPE, device="cpu")
    js, ts = jfh.get_seeds_snapshot(), fh.get_seeds_snapshot()
    assert js.keys() == ts.keys() and len(ts["mu"]) > 0
    for k in js:
        close(ts[k], js[k], k, 1e-6)
    for slot in (int(np.flatnonzero(np.asarray(jfh.map.kf.active))[0]),
                 jfh.map.kf.active.shape[0] - 1):
        jd, td = jfh.dense_input(slot), fh.dense_input(slot)
        if jd is None:
            assert td is None
            continue
        for k in ("min_depth", "max_depth", "frame_id"):
            assert td[k] == pytest.approx(jd[k], rel=1e-6), k
        close(td["image"], jd["image"], "image", 1e-4)
        close(td["T_w_f"].t.numpy(), jd["T_w_f"].t, "T_w_f", 1e-6)


def test_state_from_handler_matches_jax(hrun):
    r = hrun
    fh = handler_from_numpy(jax_handler_tree(r["fh"]), r["cam"], r["tcfg"],
                            SHAPE, device="cpu")
    t = state_to_numpy(tfused.state_from_handler(fh))
    j = jax_tree(jfused.state_from_handler(r["fh"]))
    for k in ("R", "t", "frame_id", "feat_px", "feat_point", "feat_valid",
              "stage", "num_obs_last", "scrub_pending"):
        close(t[k], j[k], k, 0)
    close(t["pad"]["stack"], j["pad"]["stack"], "pad", 0)


def test_handler_runs_on_cuda_unless_told_otherwise(hrun):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    with pytest.raises(RuntimeError):
        FrameHandler(hrun["cam"], hrun["tcfg"], img_shape=SHAPE)
