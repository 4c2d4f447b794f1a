"""The port's two-view bootstrap against the JAX package on the CPU: the
KLT pyramid and tracker, midpoint triangulation, the homography (DLT,
transfer error, RANSAC with the JAX draw fed in, decomposition), two-view
BA, and FrameHandler's self-bootstrap from frame 0 to the default stage.

The scene is the whole-step scene of tests/_torch_port.py with a 25 px
disparity gate (its circle never reaches the default 50 px), frames fed at
a stride of 2: the JAX handler bootstraps at frame 4.  torch cannot
reproduce jax.random's stream, so the parity tests replace the port's
RANSAC draw (ops/homography.ransac_draw) by JAX's categorical draw for the
same key; the port's own draw is held to the same inlier set.
Tolerances: discrete results exactly; KLT positions to 1e-3 px; the
homography up to sign to 1e-4 (eigenvector signs are arbitrary); poses to
1e-4; points to 1e-4 relative."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_svo_tpu import config as jconfig
from rpg_svo_tpu.core import local_ba as jlba
from rpg_svo_tpu.core import map as jmap
from rpg_svo_tpu.core.pipeline import FrameHandler as JFrameHandler
from rpg_svo_tpu.geometry.se3 import SE3 as JSE3
from rpg_svo_tpu.geometry.triangulation import \
    triangulate_midpoint as jtriangulate
from rpg_svo_tpu.ops import homography as jhom
from rpg_svo_tpu.ops.detector import detect_features as jdetect
from rpg_svo_tpu.ops.lk import track_klt as jklt
from rpg_svo_tpu.ops.pyramid import build_lk_pyramid as jlk_pyramid
from rpg_svo_tpu.ops.pyramid import build_pyramid as jbuild
from rpg_svo_tpu.utils.synthetic import SyntheticDataset
from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch.core import local_ba as tlba
from rpg_svo_tpu_torch.core.convert import (
    handler_from_numpy, handler_to_numpy, map_from_numpy)
from rpg_svo_tpu_torch.core.pipeline import FrameHandler
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3
from rpg_svo_tpu_torch.geometry.triangulation import triangulate_midpoint
from rpg_svo_tpu_torch.ops import homography as thom
from rpg_svo_tpu_torch.ops.lk import track_klt
from rpg_svo_tpu_torch.ops.pyramid import build_lk_pyramid
from rpg_svo_tpu_torch.utils.synthetic import reference_test_camera

from _torch_port import (FULL_KW, FULL_SCENE, SHAPE, close, jax_handler_tree,
                         jax_tree)

BOOT_KW = dict(FULL_KW, init_min_disparity=25.0)
STRIDE = 2
N_BOOT = 13              # frames 0, 2, ..., 12
BOOT_FRAME = 4


def T(a):
    return torch.from_numpy(np.array(a))


def jax_draw(valid, n, generator):
    """The JAX package's minimal samples for PRNGKey(seed): the
    replacement of the port's ransac_draw in the parity tests."""
    logits = jnp.where(jnp.asarray(valid.numpy()), 0.0, -1e9)
    idx = jax.random.categorical(jax.random.PRNGKey(generator.initial_seed()),
                                 logits[None, :], shape=(n, 4))
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


def _up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign(np.sum(a * b))
    np.testing.assert_allclose(a * s, b, atol=atol)


def _snapshot(fh):
    """A JAX FrameHandler that add_image on the original leaves as it is
    (its arrays are immutable; the initializer and the log are not)."""
    h = copy.copy(fh)
    h.initializer = copy.copy(fh.initializer)
    h.log = []
    return h


@pytest.fixture(scope="module")
def boot():
    """The JAX FrameHandler from frame 0 at stride 2: per-frame infos,
    poses and the handler state before each frame."""
    ds = SyntheticDataset(**FULL_SCENE)
    jcfg = jconfig.fast_preset(**BOOT_KW)
    fh = JFrameHandler(ds.cam, jcfg, img_shape=SHAPE)
    frames = list(range(0, N_BOOT, STRIDE))
    imgs = {i: np.asarray(ds.frame(i)[0]) for i in frames}
    infos, t_wc, before, before_handler = [], [], {}, {}
    for i in frames:
        before[i] = jax_handler_tree(fh)
        before_handler[i] = _snapshot(fh)
        infos.append(fh.add_image(jnp.asarray(imgs[i]), i / 50.0))
        t_wc.append(np.asarray(fh.last_frame.T_f_w.inverse().t))
        if i == BOOT_FRAME:
            boot_map = jax_tree(fh.map)
            boot_handler = copy.copy(fh)
    return dict(ds=ds, jcfg=jcfg, tcfg=tconfig.fast_preset(**BOOT_KW),
                frames=frames, imgs=imgs, infos=infos, t_wc=t_wc,
                before=before, before_handler=before_handler,
                boot_map=boot_map, boot_handler=boot_handler,
                cam=reference_test_camera(SHAPE[1], SHAPE[0]))


def test_build_lk_pyramid_matches_jax(boot):
    img = boot["imgs"][0]
    want = jlk_pyramid(jnp.asarray(img), 5)
    got = build_lk_pyramid(T(img), 5)
    for lw, lg in zip(want, got):
        close(lg.numpy(), lw, "level", 1e-5, rtol=1e-6)


def test_track_klt_matches_jax(boot):
    """31x31 windows over the detected corners, 5 levels: the same
    corners converge, to 1e-3 px (frame 0 to frame 4, ~30 px away)."""
    r = boot
    pyr0 = jbuild(jnp.asarray(r["imgs"][0]), 3)
    C = r["boot_handler"].n_cells
    det = jdetect(pyr0, jnp.zeros((C,), bool), 12)
    ref = jlk_pyramid(jnp.asarray(r["imgs"][0]), 5)
    cur = jlk_pyramid(jnp.asarray(r["imgs"][4]), 5)
    px, ok = jklt(ref, cur, det["px"], det["valid"])
    tpx, tok = track_klt(build_lk_pyramid(T(r["imgs"][0]), 5),
                         build_lk_pyramid(T(r["imgs"][4]), 5),
                         T(det["px"]), T(det["valid"]))
    close(tok.numpy(), ok, "ok", 0)
    ok = np.asarray(ok)
    assert ok.sum() > 200
    close(tpx.numpy()[ok], np.asarray(px)[ok], "px_cur", 1e-3, rtol=0)


def test_triangulate_midpoint_matches_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, [0.1] * 3 + [0.05] * 3).astype(np.float32)
    p = rng.uniform([-1, -1, 2], [1, 1, 4], (200, 3)).astype(np.float32)
    Tj = JSE3.exp(jnp.asarray(xi))
    Tt = TSE3.exp(T(xi))
    f_ref = p / np.linalg.norm(p, axis=-1, keepdims=True)
    pc = np.asarray(Tj.apply(jnp.asarray(p)))
    f_cur = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    f_cur[:5] = f_ref[:5]                    # parallel rays: not ok
    pw, ok = jtriangulate(JSE3.identity(), Tj.inverse(), jnp.asarray(f_ref),
                          jnp.asarray(f_cur))
    tpw, tok = triangulate_midpoint(TSE3.identity(), Tt.inverse(), T(f_ref),
                                    T(f_cur))
    close(tok.numpy(), ok, "ok", 0)
    ok = np.asarray(ok)
    assert 150 < ok.sum() < 200
    close(tpw.numpy()[ok], np.asarray(pw)[ok], "p_w", 1e-5, rtol=1e-5)


def _homography_pairs(n=128, n_bad=30, seed=1):
    rng = np.random.default_rng(seed)
    H = np.array([[1.0, 0.01, 0.05], [-0.02, 1.0, -0.03],
                  [0.02, 0.01, 1.0]], np.float32)
    uv1 = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    p = np.concatenate([uv1, np.ones((n, 1), np.float32)], -1) @ H.T
    uv2 = (p[:, :2] / p[:, 2:3]).astype(np.float32)
    uv2[:n_bad] += rng.normal(0, 0.2, (n_bad, 2)).astype(np.float32)
    return uv1, uv2


def test_solve_h_and_transfer_error_match_jax():
    """Batched minimal solves and the weighted refit, H up to sign.  The
    solve takes the eigenvector of the float32 normal matrix A^T A, so
    two libraries agree to about eps / gap, the gap being the second
    smallest eigenvalue over the largest: minimal samples with a gap above
    1e-3 agree to 1e-4 (below it, both packages return float32 noise; the
    RANSAC consensus decides among samples, not these bits), the refit
    over 98 correspondences to 1e-5.  The transfer error of one H to
    1e-5."""
    uv1, uv2 = _homography_pairs()
    rng = np.random.default_rng(2)
    idx = np.stack([rng.choice(np.arange(30, 128), 4, replace=False)
                    for _ in range(256)])
    Hj = jhom._solve_h(jnp.asarray(uv1[idx]), jnp.asarray(uv2[idx]))
    Ht = thom._solve_h(T(uv1[idx]), T(uv2[idx]))
    rows = np.asarray(jhom._dlt_rows(jnp.asarray(uv1[idx]),
                                     jnp.asarray(uv2[idx])))
    rows = rows.reshape(256, 8, 9).astype(np.float64)
    ev = np.linalg.eigvalsh(np.einsum("sni,snj->sij", rows, rows))
    conditioned = ev[:, 1] / ev[:, -1] > 1e-3
    assert conditioned.sum() >= 20
    for a, b in zip(Ht.numpy()[conditioned], np.asarray(Hj)[conditioned]):
        _up_to_sign(a, b, 1e-4)
    w = (np.arange(128) >= 30).astype(np.float32)
    Hj1 = jhom._solve_h(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(w))
    Ht1 = thom._solve_h(T(uv1), T(uv2), T(w))
    _up_to_sign(Ht1.numpy(), Hj1, 1e-5)
    ej = jhom._transfer_error(Hj, jnp.asarray(uv1)[None],
                              jnp.asarray(uv2)[None])
    et = thom._transfer_error(T(Hj), T(uv1)[None], T(uv2)[None])
    close(et.numpy(), ej, "transfer error", 1e-5, rtol=1e-5)


def test_estimate_homography_with_the_jax_draw_matches_jax():
    uv1, uv2 = _homography_pairs()
    valid = np.ones(128, bool)
    valid[100:105] = False
    key = jax.random.PRNGKey(3)
    want = jhom.estimate_homography(jnp.asarray(uv1), jnp.asarray(uv2),
                                    jnp.asarray(valid), key,
                                    thresh=jnp.float32(0.005))
    gen = torch.Generator().manual_seed(3)
    got = thom.estimate_homography(T(uv1), T(uv2), T(valid),
                                   jax_draw(T(valid), 256, gen), 0.005)
    close(got.inliers.numpy(), want.inliers, "inliers", 0)
    assert int(got.n_inliers) == int(want.n_inliers) > 90
    _up_to_sign(got.H.numpy(), want.H, 1e-4)
    assert bool(got.decomp_ok) == bool(want.decomp_ok)
    close(got.T_cur_ref.R.numpy(), want.T_cur_ref.R, "R", 1e-4)
    close(got.T_cur_ref.t.numpy(), want.T_cur_ref.t, "t", 1e-4)
    # the port's own draw finds the same consensus set on this data
    own = thom.estimate_homography(
        T(uv1), T(uv2), T(valid),
        thom.ransac_draw(T(valid), 256, torch.Generator().manual_seed(3)),
        0.005)
    close(own.inliers.numpy(), want.inliers, "inliers, own draw", 0)


def test_ransac_draw_samples_the_valid_entries_uniformly():
    valid = torch.zeros(300, dtype=torch.bool)
    valid[torch.arange(0, 300, 3)] = True
    a = thom.ransac_draw(valid, 4000, torch.Generator().manual_seed(7))
    b = thom.ransac_draw(valid, 4000, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.shape == (4000, 4)
    assert bool(valid[a].all())
    counts = torch.bincount(a.reshape(-1), minlength=300)[valid]
    assert int(counts.min()) > 100 and int(counts.max()) < 220   # ~160


def test_decompose_planar_motion_matches_jax():
    """tests/test_initialization.py's planar case: the selected pose
    itself agrees, not only its score."""
    T_gt = JSE3.exp(jnp.array([0.2, 0.05, 0.02, 0.02, -0.03, 0.01]))
    n = jnp.array([0.0, 0.0, 1.0])
    d = 2.0
    H = T_gt.R + jnp.outer(T_gt.t, n) / d
    uv1 = jax.random.uniform(jax.random.PRNGKey(4), (96, 2), minval=-0.4,
                             maxval=0.4)
    p_ref = jnp.concatenate([uv1 * d, jnp.full((96, 1), d)], -1)
    p_cur = T_gt.apply(p_ref)
    f_ref = p_ref / jnp.linalg.norm(p_ref, axis=-1, keepdims=True)
    f_cur = p_cur / jnp.linalg.norm(p_cur, axis=-1, keepdims=True)
    Hn = H / jnp.linalg.norm(H)
    Tj, okj = jhom.decompose_homography(Hn, f_ref, f_cur, jnp.ones(96, bool))
    Tt, okt = thom.decompose_homography(T(Hn), T(f_ref), T(f_cur),
                                        torch.ones(96, dtype=torch.bool))
    assert bool(okt) and bool(okj)
    close(Tt.R.numpy(), Tj.R, "R", 1e-4)
    close(Tt.t.numpy(), Tj.t, "t", 1e-4)
    # and with -H (the other eigenvector sign)
    Tm, _ = thom.decompose_homography(-T(Hn), T(f_ref), T(f_cur),
                                      torch.ones(96, dtype=torch.bool))
    close(Tm.R.numpy(), Tj.R, "R of -H", 1e-4)
    close(Tm.t.numpy(), Tj.t, "t of -H", 1e-4)


def _port_boot(r, monkeypatch, draw=jax_draw):
    """The port's handler through the same frames, with the given draw."""
    monkeypatch.setattr(thom, "ransac_draw", draw)
    fh = FrameHandler(r["cam"], r["tcfg"], img_shape=SHAPE, device="cpu")
    infos, t_wc = [], []
    for i in r["frames"]:
        infos.append(fh.add_image(T(r["imgs"][i]), i / 50.0))
        t_wc.append(fh.last_frame.T_f_w.inverse().t.numpy())
    return fh, infos, t_wc


def test_self_bootstrap_matches_jax(boot, monkeypatch):
    """add_image from frame 0: the same stages and results frame by frame,
    the bootstrap at frame 4 with the same inliers, points to 1e-4
    relative, and the tracked frames after it to 1e-3 m."""
    r = boot
    stages = [i["stage"] for i in r["infos"]]
    assert stages[:3] == ["first", "second", "second"] \
        and set(stages[3:]) == {"default"}, stages
    assert r["infos"][2]["init_inliers"] > 200
    fh, infos, t_wc = _port_boot(r, monkeypatch)
    for ti, ji in zip(infos, r["infos"]):
        for k in ("stage", "result", "init_inliers", "repr_n_new_references",
                  "is_keyframe"):
            assert ti.get(k) == ji.get(k), (ti["frame_id"], k)
    for a, b in zip(t_wc, r["t_wc"]):
        close(a, b, "t_wc", 1e-3, rtol=0)
    # the bootstrap map: keyframes 0 and 1 and the triangulated points
    fh2 = handler_from_numpy(r["before"][BOOT_FRAME], r["cam"], r["tcfg"],
                             SHAPE, device="cpu")
    fh2.add_image(T(r["imgs"][BOOT_FRAME]), BOOT_FRAME / 50.0)
    t, j = handler_to_numpy(fh2)["map"], r["boot_map"]
    alive = j["pt"]["ptype"][:-1] > 0
    assert alive.sum() == r["infos"][2]["init_inliers"]
    close(t["pt"]["ptype"][:-1], j["pt"]["ptype"][:-1], "ptype", 0)
    np.testing.assert_allclose(t["pt"]["pos"][:-1][alive],
                               j["pt"]["pos"][:-1][alive], rtol=1e-4,
                               atol=1e-6)
    for k in ("active", "frame_id", "feat_point", "feat_valid", "feat_level"):
        close(t["kf"][k][:-1], j["kf"][k][:-1], "kf." + k, 0)
    close(t["kf"]["R"][:-1], j["kf"]["R"][:-1], "kf.R", 1e-4)
    close(t["kf"]["t"][:-1], j["kf"]["t"][:-1], "kf.t", 1e-4)
    close(t["kf"]["feat_px"][:-1], j["kf"]["feat_px"][:-1], "kf.px", 1e-3,
          rtol=0)


def test_bootstrap_with_its_own_draw_finds_the_jax_inliers(boot):
    """Without the JAX draw: from the JAX state before frame 4, the port's
    own RANSAC samples reach the same inlier set and pose."""
    r = boot
    fh = handler_from_numpy(r["before"][BOOT_FRAME], r["cam"], r["tcfg"],
                            SHAPE, device="cpu")
    info = fh.add_image(T(r["imgs"][BOOT_FRAME]), BOOT_FRAME / 50.0)
    assert fh.stage == "default"
    assert info["init_inliers"] == r["infos"][2]["init_inliers"]
    close(handler_to_numpy(fh)["map"]["kf"]["feat_valid"][:-1],
          r["boot_map"]["kf"]["feat_valid"][:-1], "inliers", 0)
    close(fh.last_frame.T_f_w.inverse().t.numpy(), r["t_wc"][2], "t_wc",
          1e-4)


def test_bootstrap_keeps_point_0s_observations_where_the_reference_loses_them(
        boot, monkeypatch):
    """Reference fault at rpg_svo_tpu/core/pipeline.py:326-328 and
    :341-343: add_point_observations over all C rows, where non-inlier
    rows hold point id -1 clipped to point 0, so the clipped scatters
    write point 0's old observation slots back over its new ones.  Point
    0 is the point of row 0, an inlier only if cell 0's corner is; here
    rows 0 and k (an inlier) of the first frame's corners are swapped
    before frame 4 in both packages.  JAX's point 0 ends the bootstrap
    without an observation; the port's has one on each bootstrap
    keyframe; everything else agrees."""
    r = boot
    jfh = _snapshot(r["before_handler"][BOOT_FRAME])
    k = int(np.flatnonzero(r["boot_map"]["kf"]["feat_valid"][
        np.argmin(np.where(r["boot_map"]["kf"]["active"],
                           r["boot_map"]["kf"]["frame_id"], 99))])[0])
    assert k > 0
    perm = np.arange(jfh.n_cells)
    perm[[0, k]] = [k, 0]
    jfh.initializer.state = jax.tree.map(lambda a: a[perm],
                                         jfh.initializer.state)
    tree = jax_handler_tree(jfh)
    jfh.add_image(jnp.asarray(r["imgs"][BOOT_FRAME]), BOOT_FRAME / 50.0)
    monkeypatch.setattr(thom, "ransac_draw", jax_draw)
    fh = handler_from_numpy(tree, r["cam"], r["tcfg"], SHAPE, device="cpu")
    fh.add_image(T(r["imgs"][BOOT_FRAME]), BOOT_FRAME / 50.0)
    t, j = handler_to_numpy(fh)["map"], jax_tree(jfh.map)
    assert jfh.stage == fh.stage == "default"
    assert j["pt"]["ptype"][0] > 0 and not j["pt"]["obs_valid"][0].any()
    assert sorted(t["pt"]["obs_kf"][0][t["pt"]["obs_valid"][0]]) == \
        sorted(np.flatnonzero(j["kf"]["active"]))
    for k_ in ("obs_kf", "obs_feat", "obs_valid"):
        close(t["pt"][k_][1:-1], j["pt"][k_][1:-1], "pt." + k_, 0)
    close(t["pt"]["ptype"][:-1], j["pt"]["ptype"][:-1], "ptype", 0)


def test_two_view_ba_matches_jax(boot):
    """run_two_view_ba on the bootstrap map with its points moved by 2 mm
    of seeded noise: keyframe 1 and the points move, outliers die."""
    r = boot
    j = r["boot_map"]
    noise = np.random.default_rng(5).normal(
        0, 2e-3, j["pt"]["pos"].shape).astype(np.float32)
    j = {**j, "pt": {**j["pt"], "pos": j["pt"]["pos"] + noise}}
    slots = np.flatnonzero(j["kf"]["active"])
    fid = j["kf"]["frame_id"][slots]
    s0, s1 = int(slots[np.argmin(fid)]), int(slots[np.argmax(fid)])
    cfg = r["tcfg"]
    fx = float(r["cam"].fx)
    jm = jax.tree.map(jnp.asarray, state_like_map(j))
    want = jlba.run_two_view_ba(jm, jnp.int32(s0), jnp.int32(s1),
                                jnp.float32(cfg.loba_robust_huber_width),
                                jnp.float32(cfg.loba_thresh), r["ds"].cam.fx,
                                n_iter=10)
    tm = map_from_numpy(j, device="cpu")
    got = tlba.run_two_view_ba(tm, torch.tensor(s0, dtype=torch.int32),
                               torch.tensor(s1, dtype=torch.int32),
                               cfg.loba_robust_huber_width, cfg.loba_thresh,
                               fx, n_iter=10)
    jw = jax_tree(want)
    close(got.kf.R.numpy()[:-1], jw["kf"]["R"][:-1], "kf.R", 1e-5)
    close(got.kf.t.numpy()[:-1], jw["kf"]["t"][:-1], "kf.t", 1e-5)
    close(got.pt.ptype.numpy()[:-1], jw["pt"]["ptype"][:-1], "ptype", 0)
    close(got.pt.pos.numpy()[:-1], jw["pt"]["pos"][:-1], "pos", 2e-4, rtol=0)
    moved = np.abs(jw["kf"]["t"][s1] - j["kf"]["t"][s1]).max()
    assert moved > 1e-5


def state_like_map(tree):
    """A JAX MapState from its dict of arrays."""
    def nt(cls, d):
        return cls(**{k: d[k] for k in cls._fields})
    return jmap.MapState(nt(jmap.KeyframeStore, tree["kf"]),
                         nt(jmap.PointStore, tree["pt"]),
                         nt(jmap.SeedStore, tree["seed"]), tree["kf_counter"])


@pytest.mark.parametrize("with_scale", [True, False])
def test_ate_matches_the_reference(with_scale):
    """The port's copy of analysis/ate.py on a scaled, rotated, noisy
    trajectory: the same numbers as the JAX package's module."""
    from rpg_svo_tpu.analysis.ate import ate_rmse as jate
    from rpg_svo_tpu_torch.analysis.ate import ate_rmse as tate
    rng = np.random.default_rng(6)
    gt = np.cumsum(rng.normal(0, 0.01, (300, 3)), axis=0)
    R = np.asarray(JSE3.exp(jnp.array([0, 0, 0, 0.2, -0.1, 0.3])).R,
                   np.float64)
    est = 0.7 * gt @ R.T + np.array([0.1, 0.2, -0.3]) \
        + rng.normal(0, 1e-4, gt.shape)
    want, got = jate(gt, est, with_scale), tate(gt, est, with_scale)
    assert got == want
    if with_scale:
        assert got["median"] < 3e-4 and abs(got["scale"] - 1 / 0.7) < 1e-2
