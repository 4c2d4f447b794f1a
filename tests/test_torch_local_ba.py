"""The port's local BA, its map helpers and the accurate preset's keyframe
step against the JAX package on the CPU.

Inputs: the JAX accurate-preset run of the whole-step scene
(tests/_torch_port.FULL_SCENE) up to the keyframe at frame 11, whose map
holds five keyframes, seeds and candidates.  Tolerances: every discrete
result exactly; problem arrays exactly; BA poses to 1e-5 and points to
2e-4 m (one solve from perturbed points, see the test) and, through a
whole keyframe step, everything to 1e-4 — except the seed
posteriors, held to 1e-3 relative for the reason given in
tests/test_torch_depth_filter.py (the triangulation's conditioning)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_svo_tpu.core import local_ba as jlba
from rpg_svo_tpu.core import map as jmap
from rpg_svo_tpu.geometry.se3 import SE3 as JSE3
from rpg_svo_tpu.ops.robust import huber_weight as jhuber
from rpg_svo_tpu_torch.core import fused as tfused
from rpg_svo_tpu_torch.core import local_ba as tlba
from rpg_svo_tpu_torch.core import map as tmap
from rpg_svo_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3
from rpg_svo_tpu_torch.ops.robust import huber_weight as thuber

from _torch_port import SHAPE, close, jax_tree, run_full

KF_FRAME = 11
POINT0_FRAME = 15       # a keyframe that matches point 0 as a candidate
DEPTH_RTOL = 1e-3
SEED_POSTERIOR = ("mu", "sigma2", "a", "b")


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def acc():
    r = run_full("accurate", POINT0_FRAME)
    assert bool(r["outs"][KF_FRAME - 1].is_keyframe)
    m = r["states"][KF_FRAME].m
    r["slot"] = int(np.nonzero(np.asarray(m.kf.frame_id) == KF_FRAME)[0][0])
    assert int(m.kf.active.sum()) >= 4
    return r


def _tmap(js):
    return state_from_numpy(jax_tree(js), device="cpu").m


def _compare_map(t, j, atol, posterior_rtol=DEPTH_RTOL):
    """Every pool field but the scratch rows; seed posteriors relative."""
    for store in ("kf", "pt", "seed"):
        for k, w in j[store].items():
            rtol = posterior_rtol if store == "seed" and k in SEED_POSTERIOR \
                else None
            close(t[store][k][:-1], w[:-1], f"{store}.{k}",
                  atol if rtol is None else 1e-6, rtol=rtol)
    close(t["kf_counter"], j["kf_counter"], "kf_counter", 0)


def test_huber_weight_matches_jax():
    x = np.random.default_rng(0).normal(0, 3, 1000).astype(np.float32)
    x[:4] = [0.0, 1.345, -1.345, 1e-13]
    close(thuber(T(x)).numpy(), jhuber(jnp.asarray(x)), "huber", 0,
          rtol=2e-7)


def test_mask_compact_priority_matches_jax():
    """Top-k by priority, lower index first among ties (many ties)."""
    rng = np.random.default_rng(1)
    for n, k in ((300, 64), (50, 80), (1000, 1000)):
        mask = rng.random(n) < 0.6
        prio = rng.integers(0, 5, n).astype(np.int32)
        ji, jv = jmap.mask_compact_priority(jnp.asarray(mask), min(k, n),
                                            jnp.asarray(prio))
        ti, tv = tmap.mask_compact_priority(T(mask), min(k, n), T(prio))
        close(ti.numpy(), ji, "idx", 0)
        close(tv.numpy(), jv, "valid", 0)


@pytest.mark.parametrize("enable", [True, False])
def test_add_keyframe_matches_jax(acc, enable):
    """The masked insert: a keyframe row written into the first free slot,
    or (disabled) nothing; the port leaves the scratch row alone."""
    js = acc["states"][KF_FRAME]
    C = js.m.kf.feat_px.shape[1]
    rng = np.random.default_rng(2)
    feats = dict(
        px=rng.uniform(0, 300, (C, 2)).astype(np.float32),
        f=rng.normal(0, 1, (C, 3)).astype(np.float32),
        level=rng.integers(0, 3, C).astype(np.int32),
        point=rng.integers(-1, 500, C).astype(np.int32),
        valid=rng.random(C) < 0.5,
        depth=rng.uniform(0.5, 3, C).astype(np.float32),
        ftype=np.zeros(C, np.int32),
        grad=rng.normal(0, 1, (C, 2)).astype(np.float32),
        tile=rng.uniform(0, 255, (C, 576)).astype(np.float32),
        xy0=rng.integers(0, 40, (C, 2)).astype(np.int32))
    order = ("px", "f", "level", "point", "valid", "depth")
    stack = rng.uniform(0, 255, js.pad.stack.shape).astype(np.float32)
    jm2, jslot = jmap.add_keyframe(
        js.m, jnp.asarray(stack), JSE3(js.R, js.t), jnp.int32(12),
        *[jnp.asarray(feats[k]) for k in order],
        feat_type=jnp.asarray(feats["ftype"]),
        feat_grad=jnp.asarray(feats["grad"]), enable=jnp.bool_(enable),
        feat_tile=jnp.asarray(feats["tile"]),
        feat_tile_xy0=jnp.asarray(feats["xy0"]))
    tm2, tslot = tmap.add_keyframe(
        _tmap(js), T(stack), TSE3(T(js.R), T(js.t)),
        torch.tensor(12, dtype=torch.int32), *[T(feats[k]) for k in order],
        feat_type=T(feats["ftype"]), feat_grad=T(feats["grad"]),
        feat_tile=T(feats["tile"]), feat_tile_xy0=T(feats["xy0"]),
        enable=torch.tensor(enable))
    assert int(tslot) == int(jslot) == (int(jslot) if enable else -1)
    j = jax_tree(jm2.kf)
    t = {k: v.numpy() for k, v in tm2.kf._asdict().items()}
    for k in j:
        close(t[k][:-1], j[k][:-1], "kf." + k, 0, rtol=0)
    before = jax_tree(js.m.kf)
    for k in t:
        close(t[k][-1], before[k][-1], "scratch row " + k, 0, rtol=0)


@pytest.mark.parametrize("which", ["oldest", "none"])
def test_delete_keyframe_matches_jax(acc, which):
    js = acc["states"][KF_FRAME]
    fid = np.where(np.asarray(js.m.kf.active), np.asarray(js.m.kf.frame_id),
                   10 ** 6)
    slot = int(np.argmin(fid)) if which == "oldest" else -1
    want = jmap.delete_keyframe(js.m, jnp.int32(slot))
    got = tmap.delete_keyframe(_tmap(js), torch.tensor(slot,
                                                       dtype=torch.int32))
    t, j = state_to_numpy_map(got), jax_tree(want)
    _compare_map(t, j, 0, posterior_rtol=0)
    if which == "oldest":
        killed = np.asarray(js.m.pt.ptype) != np.asarray(want.pt.ptype)
        assert killed.sum() > 0


def state_to_numpy_map(m):
    return {k: ({f: v.numpy() for f, v in getattr(m, k)._asdict().items()}
                if k != "kf_counter" else m.kf_counter.numpy())
            for k in ("kf", "pt", "seed", "kf_counter")}


def test_build_local_ba_problem_matches_jax(acc):
    js = acc["states"][KF_FRAME]
    prob, sel, selok, var = jlba.build_local_ba_problem(
        js.m, jnp.int32(acc["slot"]), core_n_kfs=5)
    tprob, tsel, tselok, tvar = tlba.build_local_ba_problem(
        _tmap(js), torch.tensor(acc["slot"]), core_n_kfs=5)
    close(tvar.numpy(), var, "variable", 0)
    close(tselok.numpy(), selok, "selok", 0)
    close(tsel.numpy(), sel, "sel", 0)
    for k in prob._fields:
        close(getattr(tprob, k).numpy(), getattr(prob, k), k, 0, rtol=0)
    assert np.asarray(selok).sum() > 200 and np.asarray(var).sum() >= 3


def test_run_local_ba_matches_jax(acc):
    """One local BA of the keyframe-11 map with its points moved by 2 mm
    of noise (seeded), so that the solve has work."""
    cfg = acc["tcfg"]
    js = acc["states"][KF_FRAME]
    noise = np.random.default_rng(3).normal(
        0, 2e-3, js.m.pt.pos.shape).astype(np.float32)
    js = js._replace(m=js.m._replace(pt=js.m.pt._replace(
        pos=js.m.pt.pos + noise)))
    fx = float(acc["cam"].fx)
    want = jlba.run_local_ba(
        js.m, jnp.int32(acc["slot"]), jnp.float32(cfg.loba_robust_huber_width),
        jnp.float32(cfg.loba_thresh), acc["ds"].cam.fx,
        n_iter=cfg.loba_num_iter, core_n_kfs=cfg.core_n_kfs)
    got = tlba.run_local_ba(_tmap(js), torch.tensor(acc["slot"]),
                            cfg.loba_robust_huber_width, cfg.loba_thresh, fx,
                            n_iter=cfg.loba_num_iter,
                            core_n_kfs=cfg.core_n_kfs)
    t, j = state_to_numpy_map(got), jax_tree(want)
    # a point seen over a few cm of baseline is ill-conditioned along its
    # ray: its GN steps amplify the sum-order differences of the two
    # packages (measured 1.6e-4 m on 47 of 2047 points); 1e-4 of the ~2 m
    # scene depth on points, 1e-5 on everything else
    close(t["pt"]["pos"][:-1], j["pt"]["pos"][:-1], "pt.pos", 2e-4, rtol=0)
    t["pt"]["pos"] = j["pt"]["pos"]
    _compare_map(t, j, 1e-5, posterior_rtol=0)
    moved = np.abs(np.asarray(want.pt.pos) - np.asarray(js.m.pt.pos)).max()
    assert moved > 1e-3                        # the solve did something


def test_accurate_keyframe_step_with_local_ba_matches_jax(acc):
    """The whole accurate step at keyframe frame 11 from the JAX state
    before it: insertion, binding, local BA, seeds and the outputs."""
    r = acc
    i = KF_FRAME - 1
    ts = state_from_numpy(jax_tree(r["states"][i]), device="cpu")
    ts, to = tfused.vo_step(ts, torch.from_numpy(r["imgs"][i]), r["cam"],
                            r["tcfg"], r["fh"].ncx, r["fh"].ncy, SHAPE)
    jo = r["outs"][i]
    for k in ("n_matches", "n_edges", "is_keyframe", "failed", "stage"):
        assert int(getattr(to, k)) == int(getattr(jo, k)), k
    assert bool(to.is_keyframe)
    close(to.t_wc.numpy(), jo.t_wc, "t_wc", 1e-4)
    t, j = state_to_numpy(ts), jax_tree(r["states"][KF_FRAME])
    _compare_map(t["m"], j["m"], 1e-4)
    for k in ("R", "t", "feat_px", "feat_point", "feat_valid",
              "num_obs_last", "scrub_pending"):
        close(t[k], j[k], k, 1e-4)


def test_keyframe_binds_point_0_where_the_reference_loses_it(acc):
    """Reference faults at the fused step's observation binding
    (rpg_svo_tpu/core/fused.py:343-348): rows without a valid feature clip
    their point id to 0, and the clipped scatters keep their last writer,
    so when point 0 is matched at a keyframe its new observation
    (add_point_observations) and its promotion from CANDIDATE to UNKNOWN
    (the `hit` scatter) are overwritten.  At frame 15 point 0 is a
    candidate (a converted seed) matched in a keyframe: JAX leaves it
    unbound, the port binds and promotes it; the rest of the step agrees
    (point 0's own BA position aside)."""
    r = acc
    i = POINT0_FRAME - 1
    j0 = r["states"][i]
    assert int(j0.m.pt.ptype[0]) == jmap.TYPE_CANDIDATE
    ts = state_from_numpy(jax_tree(j0), device="cpu")
    ts, to = tfused.vo_step(ts, torch.from_numpy(r["imgs"][i]), r["cam"],
                            r["tcfg"], r["fh"].ncx, r["fh"].ncy, SHAPE)
    assert bool(to.is_keyframe) and bool(r["outs"][i].is_keyframe)
    t, j = state_to_numpy(ts), jax_tree(r["states"][POINT0_FRAME])
    fp = t["feat_point"][t["feat_valid"]]
    assert 0 in fp                                  # point 0 matched
    slot = int(np.nonzero(j["m"]["kf"]["frame_id"] == POINT0_FRAME)[0][0])
    # JAX: no observation, still a candidate; the port: bound and promoted
    assert not j["m"]["pt"]["obs_valid"][0].any()
    assert j["m"]["pt"]["ptype"][0] == jmap.TYPE_CANDIDATE
    assert t["m"]["pt"]["obs_valid"][0].sum() == 1
    assert t["m"]["pt"]["obs_kf"][0][t["m"]["pt"]["obs_valid"][0]][0] == slot
    assert t["m"]["pt"]["ptype"][0] == jmap.TYPE_UNKNOWN
    for k in ("obs_kf", "obs_feat", "obs_valid", "ptype", "pos"):
        t["m"]["pt"][k][0] = j["m"]["pt"][k][0]
    _compare_map(t["m"], j["m"], 1e-4)
