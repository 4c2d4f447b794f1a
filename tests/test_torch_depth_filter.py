"""The port's depth filter, epipolar search and their map helpers against
the JAX package, on fixed inputs.

The inputs are the state after the keyframe at frame 3 of the whole-step
scene (tests/_torch_port.FULL_SCENE, tracked by the port; the JAX step
is held to it by tests/test_torch_fused.py), which holds 127 live seeds,
and frame 4's pose and image; both packages get the same numpy arrays.  Tolerances: floats to 1e-5 relative and every discrete result
exactly, with two stated exceptions.  (1) The epipolar match's depth, and
so every seed posterior (mu, sigma2, a, b) and candidate position it
feeds, to 1e-3 relative: the triangulation's normal-equation determinant
1 - cos^2 of the ray angle cancels to ~1e-3 at a few pixels of parallax,
so one float32 ulp of the matched pixel moves the depth by up to 3e-4
relative (measured: the two packages' matches differ by 3.8e-6 px, their
depths by 2.6e-4); the triangulation itself is bit-equal on equal pixels.
(2) Strip-scan scores to 1e-6 of the window's summed squared intensity
scale (the ZMSSD expansion cancels sums of ~1e5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_svo_tpu.core import depth_filter as jdf
from rpg_svo_tpu.core import frame as jframe
from rpg_svo_tpu.core import map as jmap
from rpg_svo_tpu.geometry.se3 import SE3 as JSE3
from rpg_svo_tpu.ops import feature_align as jfa
from rpg_svo_tpu.ops import matcher as jm
from rpg_svo_tpu.ops.pyramid import build_padded_pyramid as jbuild_pad
from rpg_svo_tpu.utils.synthetic import (SineSurface, SurfaceDataset,
                                         look_down_pose)
from rpg_svo_tpu_torch.core import depth_filter as tdf
from rpg_svo_tpu_torch.core import frame as tframe
from rpg_svo_tpu_torch.core import map as tmap
from rpg_svo_tpu_torch.core.convert import state_from_numpy
from rpg_svo_tpu_torch.geometry.cameras import PinholeCamera
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3
from rpg_svo_tpu_torch.ops import feature_align as tfa
from rpg_svo_tpu_torch.ops import matcher as tm
from rpg_svo_tpu_torch.ops.pyramid import build_padded_pyramid as tbuild_pad

from _torch_port import close, jax_tree, run_full

DEPTH_RTOL = 1e-3


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    r = run_full("fast", 4, jax_steps=False)
    js, jnext = r["states"][3], r["states"][4]
    assert int(js.m.seed.active.sum()) > 100      # live seeds
    r["jm"] = js.m
    r["tm"] = state_from_numpy(jax_tree(js), device="cpu").m
    r["jT"] = JSE3(jnext.R, jnext.t)
    r["tT"] = TSE3(T(jnext.R), T(jnext.t))
    img = r["imgs"][3]
    r["jpad"] = jbuild_pad(jnp.asarray(img), r["jcfg"].n_levels_total)
    r["tpad"] = tbuild_pad(T(img), r["tcfg"].n_levels_total)
    return r


def _seed_batch(r, repeat=1):
    """Search inputs of the live seeds (the full-pool path's arithmetic):
    numpy arrays, the seeds repeated ``repeat`` times."""
    m = r["jm"]
    seed = m.seed
    idx = np.tile(np.nonzero(np.asarray(seed.active))[0], repeat)
    kf = np.asarray(seed.kf_slot)[idx]
    T_kw = JSE3(m.kf.R[kf], m.kf.t[kf])
    Tcr = r["jT"] * T_kw.inverse()
    mu = np.asarray(seed.mu)[idx]
    sig = np.sqrt(np.maximum(np.asarray(seed.sigma2)[idx], 0))
    g = lambda a: np.asarray(a)[idx]  # noqa: E731
    return dict(Tcr=(np.asarray(Tcr.R), np.asarray(Tcr.t)), px=g(seed.px),
                f=g(seed.f), level=g(seed.level),
                d_est=(1 / np.maximum(mu, 1e-8)).astype(np.float32),
                d_min=(1 / np.maximum(mu + sig, 1e-8)).astype(np.float32),
                d_max=(1 / np.maximum(mu - sig, 1e-8)).astype(np.float32),
                tile=g(seed.tile), xy0=g(seed.tile_xy0), ftype=g(seed.ftype),
                grad=g(seed.grad))


def _geoms(r, b):
    cfg = r["tcfg"]
    args = ("px", "f", "level", "d_est", "d_min", "d_max")
    jg = jm.epipolar_geometry(
        r["ds"].cam, JSE3(*map(jnp.asarray, b["Tcr"])),
        *[jnp.asarray(b[k]) for k in args], max_steps=cfg.epi_max_steps,
        max_level=cfg.n_pyr_levels - 1)
    tg = tm.epipolar_geometry(
        r["cam"], TSE3(*map(T, b["Tcr"])), *[T(b[k]) for k in args],
        max_steps=cfg.epi_max_steps, max_level=cfg.n_pyr_levels - 1)
    return jg, tg


def _ref_patches(b, g):
    """JAX's warped ref patches (bordered and rotated) for geometry g."""
    args = (g.A, jnp.asarray(b["tile"]), jnp.asarray(b["xy0"]),
            jnp.asarray(b["px"]), jnp.asarray(b["level"]), g.search_level)
    rb, okb = jm.warp_affine_patches_tiles(*args)
    rr, okr = jm.warp_rotated_tiles(*args, g.dir_lvl)
    return rb, rr, okb & okr


def test_seed_variance_update_matches_jax():
    rng = np.random.default_rng(1)
    n = 512
    u = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa
    mu, sigma2 = u(0.2, 2.0), u(1e-4, 0.1)
    a, b, z_range = u(1, 30), u(1, 30), u(0.5, 3)
    x = (mu + rng.normal(0, 0.2, n)).astype(np.float32)
    tau2 = u(1e-6, 1e-2)
    tau2[:8] = 0.0                   # the guards: zero measurement variance
    sigma2[8:16] = 0.0               # and zero prior variance
    args = (mu, sigma2, a, b, z_range, x, tau2)
    want = jdf.seed_variance_update(*map(jnp.asarray, args))
    got = tdf.seed_variance_update(*map(T, args))
    # a' = (e - f) / (f - e / f) cancels: a 1-ulp difference of the two
    # libraries' exp moves it by up to 1.7e-5 relative (measured)
    for name, g, w, rtol in zip(("mu", "sigma2", "a", "b"), got, want,
                                (1e-5, 1e-5, 1e-4, 1e-4)):
        close(g.numpy(), w, name, 1e-6, rtol=rtol)


def test_compute_tau_matches_jax():
    rng = np.random.default_rng(2)
    n = 512
    f = rng.normal(0, 0.3, (n, 3))
    f[:, 2] = 1.0
    f = (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)
    t = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    z = rng.uniform(0.5, 3.0, n).astype(np.float32)
    angle = float(np.arctan(1.0 / (2.0 * 315.5)) * 2.0)
    want = jdf.compute_tau(jnp.asarray(t), jnp.asarray(f), jnp.asarray(z),
                           angle)
    got = tdf.compute_tau(T(t), T(f), T(z), angle)
    # the two libraries' acos and sin differ by an ulp on 19% and 5% of
    # inputs; tau = |t| sin(b+) / sin(g+) - z divides by sin(g+), small at
    # short baselines, and cancels against z: measured 3.5e-4 relative
    close(got.numpy(), want, "tau", 1e-7, rtol=DEPTH_RTOL)


def test_epipolar_geometry_matches_jax(scene):
    jg, tg = _geoms(scene, _seed_batch(scene))
    for k in jg._fields:
        close(getattr(tg, k).numpy(), getattr(jg, k), k, 1e-5, rtol=1e-5)


@pytest.mark.parametrize("steps,rows", [(32, 4), (8, 4), (32, 8)])
def test_strip_scan_matches_jax(scene, steps, rows):
    b = _seed_batch(scene)
    jg, _ = _geoms(scene, b)
    _, rr, _ = _ref_patches(b, jg)
    js, ji = jax.jit(jm._strip_scan, static_argnums=(6, 7))(
        scene["jpad"].flat_view(), jg.pxA, jg.dir_lvl, jg.search_level,
        jg.n_steps, rr, steps, rows)
    ts, ti = tm._strip_scan(scene["tpad"].flat_view(), T(jg.pxA),
                            T(jg.dir_lvl), T(jg.search_level), T(jg.n_steps),
                            T(rr), steps, rows)
    close(ti.numpy(), ji, "best step", 0)
    fin = np.isfinite(np.asarray(js))
    close(np.isfinite(ts.numpy()), fin, "finite", 0)
    assert fin.sum() > len(fin) // 2
    close(ts.numpy()[fin], np.asarray(js)[fin], "score",
          1e-6 * 8 * rows * 255.0 ** 2, rtol=0)


@pytest.mark.parametrize("tiers", ["single", "two"])
def test_epipolar_search_matches_jax(scene, tiers):
    """The whole search: one strip, or the two-tier scan with a 2-step
    short tier and the seeds repeated 4x (508 items), so that the 128-row
    long table defers some."""
    cfg = scene["tcfg"]
    b = _seed_batch(scene, repeat=4 if tiers == "two" else 1)
    jg, _ = _geoms(scene, b)
    rb, rr, ok = _ref_patches(b, jg)
    n = len(b["px"])
    valid = np.ones(n, bool)
    kw = dict(max_steps=cfg.epi_max_steps, scan_rows=cfg.epi_scan_rows,
              short_steps=2 if tiers == "two" else 0,
              long_k=100)
    want = jax.jit(functools.partial(jm.epipolar_search, **kw))(
        scene["jpad"].flat_view(), scene["ds"].cam, jg,
        JSE3(*map(jnp.asarray, b["Tcr"])), jnp.asarray(b["f"]), rb, rr, ok,
        jnp.asarray(valid), ftr_type=jnp.asarray(b["ftype"]),
        ftr_grad=jnp.asarray(b["grad"]), cur_pad=scene["jpad"])
    got = tm.epipolar_search(
        scene["tpad"], scene["cam"], tm.EpipolarGeom(*map(T, jg)),
        TSE3(*map(T, b["Tcr"])), T(b["f"]), T(rb), T(rr), T(ok), T(valid),
        ftr_type=T(b["ftype"]), ftr_grad=T(b["grad"]), **kw)
    for k in ("level_cur", "success", "scanned"):
        close(getattr(got, k).numpy(), getattr(want, k), k, 0)
    if tiers == "two":
        assert not np.asarray(want.scanned).all()     # some deferred
    s = np.asarray(want.success)
    assert s.sum() > n // 2
    close(got.px_cur.numpy()[s], np.asarray(want.px_cur)[s], "px_cur", 1e-4,
          rtol=1e-5)
    close(got.depth_ref.numpy()[s], np.asarray(want.depth_ref)[s],
          "depth_ref", 1e-6, rtol=DEPTH_RTOL)


def test_align2d_matches_jax(scene):
    """align2D at the scan's best windows (search-level coordinates)."""
    b = _seed_batch(scene)
    jg, _ = _geoms(scene, b)
    rb, _, ok = _ref_patches(b, jg)
    start = np.asarray(jg.pxA) + 1.3 * np.asarray(jg.dir_lvl)
    jp, jc = jfa.align2d(scene["jpad"], rb, jnp.asarray(start), ok,
                         level=jg.search_level)
    tp, tc = tfa.align2d(scene["tpad"], T(rb), T(start), T(ok),
                         level=T(jg.search_level))
    close(tc.numpy(), jc, "converged", 0)
    assert np.asarray(jc).sum() > len(start) // 2
    close(tp.numpy(), jp, "px", 1e-4, rtol=1e-5)


@pytest.mark.parametrize("enable", [True, False])
def test_init_seeds_from_detection_matches_jax(scene, enable):
    rng = np.random.default_rng(3)
    n = 96
    det = {"px": rng.uniform(20, 200, (n, 2)).astype(np.float32),
           "score": rng.uniform(0, 60, n).astype(np.float32),
           "level": rng.integers(0, 3, n).astype(np.int32),
           "valid": rng.random(n) < 0.8,
           "tile": rng.uniform(0, 255, (n, 576)).astype(np.float32),
           "tile_xy0": rng.integers(0, 50, (n, 2)).astype(np.int32)}
    m = scene["states"][2].m        # before keyframe 3: free seed slots
    slot, dmean, dmin = 2, 1.4, 0.6
    want = jdf.init_seeds_from_detection(
        m, jnp.int32(slot), {k: jnp.asarray(v) for k, v in det.items()},
        scene["ds"].cam, jnp.float32(dmean), jnp.float32(dmin),
        enable=jnp.bool_(enable))
    tm0 = state_from_numpy(jax_tree(scene["states"][2]), device="cpu").m
    got = tdf.init_seeds_from_detection(
        tm0, torch.tensor(slot, dtype=torch.int32),
        {k: T(v) for k, v in det.items()}, scene["cam"],
        torch.tensor(dmean), torch.tensor(dmin),
        enable=torch.tensor(enable))
    close(got.kf_counter.numpy(), want.kf_counter, "kf_counter", 0)
    jw, tw = jax_tree(want.seed), {k: v.numpy()
                                   for k, v in got.seed._asdict().items()}
    for k in jw:
        close(tw[k][:-1], jw[k][:-1], "seed." + k, 1e-6)
    if enable:
        assert tw["active"].sum() > int(np.asarray(m.seed.active).sum())


@pytest.mark.parametrize("i", [0, 2, 3])
def test_has_update_work_matches_jax(scene, i):
    """States without seeds (0), before keyframe 3 (2), with live seeds
    (3), against the next frame's pose; and every seed aged out."""
    js, jn = scene["states"][i], scene["states"][i + 1]
    tmm = state_from_numpy(jax_tree(js), device="cpu").m
    for counter in (int(js.m.kf_counter), int(js.m.kf_counter) + 9):
        want = jdf.has_update_work(js.m._replace(kf_counter=jnp.int32(
            counter)), JSE3(jn.R, jn.t), scene["ds"].cam, max_n_kfs=3)
        got = tdf.has_update_work(tmm._replace(kf_counter=torch.tensor(
            counter, dtype=torch.int32)), TSE3(T(jn.R), T(jn.t)),
            scene["cam"], max_n_kfs=3)
        assert bool(got) == bool(want), (i, counter)
    assert bool(want) == (i == 3)


@pytest.mark.parametrize("mode", ["compacted", "full", "disabled"])
def test_update_seeds_fields_matches_jax(scene, mode):
    cfg = scene["tcfg"]
    k = {"compacted": cfg.df_update_k, "full": 0, "disabled": 96}[mode]
    kw = dict(max_n_kfs=cfg.df_max_kf_age,
              conv_thresh=cfg.seed_convergence_sigma2_thresh,
              max_steps=cfg.epi_max_steps, update_k=k,
              short_steps=cfg.epi_short_steps, long_k=cfg.epi_long_k,
              max_level=cfg.n_pyr_levels - 1, scan_rows=cfg.epi_scan_rows)
    enable = mode != "disabled"
    want = jax.jit(functools.partial(jdf.update_seeds_fields, **kw))(
        scene["jm"], scene["jpad"].flat_view(), scene["jT"],
        scene["ds"].cam, cur_pad=scene["jpad"], enable=jnp.bool_(enable))
    got = tdf.update_seeds_fields(scene["tm"], scene["tpad"], scene["tT"],
                                  scene["cam"], enable=torch.tensor(enable),
                                  **kw)
    for name in ("active", "converged", "upd_count"):
        close(getattr(got, name).numpy(), getattr(want, name), name, 0)
    for name in want.stats._fields:
        assert int(getattr(got.stats, name)) == \
            int(getattr(want.stats, name)), name
    for name in ("mu", "sigma2", "a", "b"):
        close(getattr(got, name).numpy(), getattr(want, name), name, 1e-6,
              rtol=DEPTH_RTOL)
    # positions f / mu in a ~2 m scene: 1e-3 of the depth
    close(got.p_w.numpy(), want.p_w, "p_w", DEPTH_RTOL * 2.0, rtol=0)
    if enable:
        assert int(want.stats.n_updated) > 20
        # only the compacted path leaves seeds unserved
        served = np.asarray(want.upd_count) > np.asarray(
            scene["jm"].seed.upd_count)
        assert served.sum() == k if k else served.sum() > k
    else:
        close(got.mu.numpy(), np.asarray(scene["jm"].seed.mu), "mu", 0)
        ident = tdf.identity_seed_update(scene["tm"].seed)
        for a, b in zip(got[:-1], ident[:-1]):
            assert torch.equal(a, b)


def test_identity_and_apply_seed_update_match_jax(scene):
    """JAX's field update with some seeds marked converged, applied by both
    packages: candidate points allocated in seed order, seeds freed."""
    jm0 = scene["jm"]
    upd = jdf.identity_seed_update(jm0.seed)
    tupd = tdf.identity_seed_update(scene["tm"].seed)
    for a, b in zip(tupd[:-1], upd[:-1]):
        close(a.numpy(), b, "identity", 0)
    conv = np.zeros(jm0.seed.active.shape, bool)
    conv[np.nonzero(np.asarray(jm0.seed.active))[0][::7]] = True
    p_w = np.random.default_rng(4).normal(0, 1, (len(conv), 3)) \
        .astype(np.float32)
    upd = upd._replace(converged=jnp.asarray(conv), p_w=jnp.asarray(p_w),
                       active=upd.active & ~jnp.asarray(conv))
    want = jdf.apply_seed_update(jm0, upd)
    tupd = tdf.SeedFieldUpdate(*[T(a) for a in upd[:-1]], tupd.stats)
    got = tdf.apply_seed_update(scene["tm"], tupd)
    jw = jax_tree(want)
    tw = {k: {f: v.numpy() for f, v in getattr(got, k)._asdict().items()}
          for k in ("pt", "seed")}
    for k in ("pt", "seed"):
        for f in jw[k]:
            close(tw[k][f][:-1], jw[k][f][:-1], f"{k}.{f}", 0)
    n_cand = (jw["pt"]["ptype"] == jmap.TYPE_CANDIDATE).sum()
    assert n_cand == conv.sum() > 10


def test_alloc_points_writes_only_allocated_rows():
    """Reference fault: alloc_points (rpg_svo_tpu/core/map.py:466-467)
    clears obs_valid with a clipped scatter, so rows that allocate nothing
    write point 0's old observation flags back over a fresh allocation of
    point 0.  The port writes only allocated rows."""
    m = jmap.init_map(2, 8, 16, 4, 8, (8, 8))
    # point 0 free but with a stale observation flag (no scrub ran)
    pt = m.pt._replace(obs_valid=m.pt.obs_valid.at[0, 1].set(True))
    valid = jnp.asarray([True, False, False, True])
    args = (jnp.ones((4, 3)), jmap.TYPE_CANDIDATE, jnp.zeros(4, jnp.int32),
            jnp.zeros((4, 2)), jnp.tile(jnp.asarray([0.0, 0.0, 1.0]),
                                        (4, 1)),
            jnp.zeros(4, jnp.int32), valid)
    jpt, jids = jmap.alloc_points(pt, *args)
    assert int(jids[0]) == 0
    assert bool(jpt.obs_valid[0, 1])           # the stale flag survives
    tpt0 = tmap.PointStore(**{k: T(v) for k, v in
                              jax_tree(pt).items()})
    tpt, tids = tmap.alloc_points(tpt0, *[T(a) if hasattr(a, "shape") else a
                                          for a in args])
    close(tids.numpy(), jids, "ids", 0)
    assert not tpt.obs_valid[0].any()          # cleared, as allocated


def test_scene_depth_matches_jax(scene):
    js = scene["states"][4]
    fs = jframe.make_frame(jnp.asarray(scene["imgs"][3]), 5,
                           js.feat_px.shape[0], 4, 0.0, JSE3(js.R, js.t))
    fs = fs._replace(feat_point=js.feat_point, feat_valid=js.feat_valid)
    want = jframe.scene_depth(fs, js.m.pt.pos)
    got = tframe.scene_depth(TSE3(T(js.R), T(js.t)), T(js.feat_point),
                             T(js.feat_valid), T(js.m.pt.pos))
    for g, w in zip(got, want):
        close(g.numpy(), w, "depth", 1e-6, rtol=1e-6)


def test_epipolar_sweep_meets_goldens_on_the_port():
    """tests/test_golden_protocols.py's epipolar sweep (reference goldens
    p50 0.0832, p80 0.1618, p95 0.2635 x100 m, svo/test/test_matcher.cpp:
    84-127) on the port's epipolar_match, with the JAX renderer's images of
    the flat surface and the same thresholds, on every other point of its
    6-px grid (percentiles are stable under subsampling)."""
    ds = SurfaceDataset(n_frames=2, surf=SineSurface(amp=0.0))
    T_ref = look_down_pose(0.1131, 0.1131, 2.0)
    T_cur = look_down_pose(0.5673, 0.5641, 2.0, yaw=0.004)
    img_ref, depth_ref = ds._render(T_ref)
    img_cur, _ = ds._render(T_cur)
    H, W = ds.shape
    ys, xs = np.mgrid[4:H - 4:12, 4:W - 4:6]
    px = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    gt = np.asarray(depth_ref)[ys.ravel(), xs.ravel()]
    c = ds.cam
    cam = PinholeCamera.make(W, H, c.fx, c.fy, c.cx, c.cy)
    Tcr = T_cur.inverse() * T_ref
    n = len(px)
    res = tm.epipolar_match(
        tbuild_pad(T(img_cur), 5), tbuild_pad(T(img_ref), 5), cam,
        TSE3(T(Tcr.R), T(Tcr.t)), T(px), cam.cam2world(T(px)),
        torch.zeros(n, dtype=torch.int32), T(gt),
        torch.clamp(T(gt) - 0.8, min=0.1), T(gt) + 0.8,
        torch.ones(n, dtype=torch.bool))
    ok = res.success.numpy()
    err = np.abs(res.depth_ref.numpy() - gt)[ok] * 100
    assert ok.sum() > 0.5 * n, f"only {ok.sum()}/{n} converged"
    p50, p80, p95 = np.percentile(err, [50, 80, 95])
    assert p50 < 0.0832, f"p50 {p50:.4f} above reference golden"
    assert p80 < 0.1618, f"p80 {p80:.4f} above reference golden"
    assert p95 < 0.2635, f"p95 {p95:.4f} above reference golden"
