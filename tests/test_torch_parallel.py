"""The port's parallel layer (rpg_svo_tpu_torch.parallel) against the JAX
package's, on the CPU.

Streams: ``vmapped_vo_step`` over B = 4 diverged streams of the
whole-step scene (the states after frames 2, 4, 6 and 8) for 3 steps.
Each stream equals the port's own single-stream ``vo_step`` to 1e-6 m
(0 m, bit for bit, on the CPU) with equal keyframes and match counts, in
both presets, and JAX's
``vmapped_vo_step`` on the same states to the three-step tolerance of
tests/test_torch_fused.py (1e-4 m).  No op of the batched step takes
vmap's per-stream fallback.  The custom ops of kernels K1 and K2 batch
exactly like their plain twins stream by stream.

Mesh programs: one gloo world of 4 ranks on the CPU
(tests/_torch_parallel_worker.py, imports only the port) laid out as 2
hosts x 2, with numpy inputs made here from a seed.  The JAX figures come
from the 8 virtual CPU devices of tests/conftest.py.  Tolerances: the
sharded seed update and JAX's each to the float64 update (1e-6, and
2.5e-5 relative for the Beta parameters, see SEED_AB_RTOL) with an equal
convergence count;
the sharded pose to 1e-5 m of JAX's and 1e-3 m of the ground truth;
distributed and multi-host BA within 5e-4 of the single-device
``solve_ba`` (the bound of tests/test_parallel.py) and of JAX's
``distributed_ba_solve``; ``vo_scan_mesh`` within 1e-4 m of the
single-rank scan on every rank (tests/test_parallel.py's bound);
``multistream_scan`` 1e-6 m of each stream's single-process run and 2e-3
m of JAX's (tests/_multihost_track_worker.py's bound).
"""

import os
import pickle
import socket
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu.ba.schur import BAProblem as JBAProblem
from rpg_svo_tpu.geometry.se3 import SE3 as JSE3
from rpg_svo_tpu.parallel import streams as jstreams
from rpg_svo_tpu.parallel.ba import distributed_ba_solve as jba_solve
from rpg_svo_tpu.parallel.sharded import make_mesh as jmake_mesh
from rpg_svo_tpu.parallel.sharded import sharded_pose_optimize as jpose_opt
from rpg_svo_tpu.parallel.sharded import sharded_seed_update as jseed_update
from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch.ba.schur import BAProblem, solve_ba
from rpg_svo_tpu_torch.core import depth_filter as tdf
from rpg_svo_tpu_torch.core import fused as tfused
from rpg_svo_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3
from rpg_svo_tpu_torch.ops import align_kernel, tiles
from rpg_svo_tpu_torch.ops.pyramid import build_padded_pyramid
from rpg_svo_tpu_torch.ops.sparse_align import sparse_img_align_plain
from rpg_svo_tpu_torch.parallel import gspmd, multihost, sharded, streams
from rpg_svo_tpu_torch.utils.synthetic import reference_test_camera

from _torch_port import FULL_KW, SHAPE, jax_tree, run_full, to_torch

WORKER = os.path.join(os.path.dirname(__file__),
                      "_torch_parallel_worker.py")
WORLD = 4
STARTS = (2, 4, 6, 8)      # the streams: the states after these frames
N_STEPS = 3                # batched steps
SCAN_FROM, SCAN_FRAMES = 5, 6
STREAM_FRAMES = 6
BA_ITERS = 8
ATOL_STREAM = 1e-6
ATOL_JAX = 1e-4


@pytest.fixture(scope="module")
def full():
    """The JAX step over frames 1-14 of the whole-step scene."""
    return run_full("fast", max(STARTS) + STREAM_FRAMES)


def _port_run(full, preset: str, n: int):
    """The port's own states over frames 0..n (seeded by the port)."""
    cfg = getattr(tconfig, f"{preset}_preset")(**FULL_KW)
    Tfw = full["T0"].inverse()
    s = tfused.seed_first_frame_with_depth(
        to_torch(full["img0"]), TSE3(to_torch(Tfw.R), to_torch(Tfw.t)),
        to_torch(full["depth0"]), full["cam"], cfg, img_shape=SHAPE,
        device="cpu")
    out = [s]
    for img in full["imgs"][:n]:
        s, _ = tfused.vo_step(s, to_torch(img), full["cam"], cfg,
                              full["fh"].ncx, full["fh"].ncy, SHAPE)
        out.append(s)
    return cfg, out


def _stream_states(full, preset: str):
    """(config, the B port states): JAX's states converted (fast), the
    port's own run (accurate)."""
    if preset == "fast":
        return full["tcfg"], [state_from_numpy(jax_tree(full["states"][k]),
                                               device="cpu")
                              for k in STARTS]
    cfg, states = _port_run(full, preset, max(STARTS))
    return cfg, [states[k] for k in STARTS]


def _imgs(full, step: int) -> torch.Tensor:
    """Each stream's image of batched step ``step`` (frame start+1+step)."""
    return torch.stack([to_torch(full["imgs"][k + step]) for k in STARTS])


def _vmapped_run(full, cfg, states, n=N_STEPS):
    st = streams.stack_states(states)
    outs = []
    for j in range(n):
        st, out = streams.vmapped_vo_step(st, _imgs(full, j), full["cam"],
                                          cfg, full["fh"].ncx,
                                          full["fh"].ncy, SHAPE)
        outs.append(out)
    return st, outs


def test_stack_and_index_states_round_trip(full):
    states = _stream_states(full, "fast")[1]
    batched = streams.stack_states(states)
    assert batched.pad.stack.shape[0] == len(STARTS)
    assert batched.pad.shapes == states[0].pad.shapes
    for b, s in enumerate(states):
        back = state_to_numpy(streams.index_state(batched, b))
        want = state_to_numpy(s)
        flat_b = torch.utils._pytree.tree_leaves(back)
        flat_w = torch.utils._pytree.tree_leaves(want)
        assert len(flat_b) == len(flat_w)
        for x, y in zip(flat_b, flat_w):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_vmapped_step_matches_single_streams(full, preset):
    """Every stream of the batched step equals its own single-stream step
    over 3 steps, keyframes (inside the batch too) and depth-filter
    updates included."""
    cfg, states = _stream_states(full, preset)
    _, outs = _vmapped_run(full, cfg, states)
    kfs = []
    for b, s in enumerate(states):
        for j in range(N_STEPS):
            s, o = tfused.vo_step(s, _imgs(full, j)[b], full["cam"], cfg,
                                  full["fh"].ncx, full["fh"].ncy, SHAPE)
            got = outs[j]
            assert bool(got.is_keyframe[b]) == bool(o.is_keyframe), (b, j)
            assert int(got.n_matches[b]) == int(o.n_matches), (b, j)
            assert not bool(got.failed[b])
            np.testing.assert_allclose(got.t_wc[b].numpy(), o.t_wc.numpy(),
                                       atol=ATOL_STREAM, rtol=0)
            np.testing.assert_allclose(got.R_fw[b].numpy(), o.R_fw.numpy(),
                                       atol=ATOL_STREAM, rtol=0)
            kfs.append(bool(o.is_keyframe))
    assert any(kfs), "no keyframe inside the batch"
    # the streams really diverge
    spread = np.ptp(outs[-1].t_wc.numpy(), axis=0).max()
    assert spread > 1e-4, spread


def test_vmapped_step_matches_jax_vmapped_step(full):
    """The port's batched step against JAX's vmapped_vo_step on the same
    states, and each JAX stream against JAX's own single-stream run."""
    cfg, states = _stream_states(full, "fast")
    _, outs = _vmapped_run(full, cfg, states)
    jst = jstreams.stack_states([full["states"][k] for k in STARTS])
    jcam = full["ds"].cam
    for j in range(N_STEPS):
        jimgs = jnp.asarray(_imgs(full, j).numpy())
        jst, jo = jstreams.vmapped_vo_step(jst, jimgs, jcam, full["jcfg"],
                                           full["fh"].ncx, full["fh"].ncy,
                                           SHAPE)
        for b, k in enumerate(STARTS):
            for key in ("n_matches", "n_edges", "is_keyframe", "failed",
                        "stage"):
                assert int(getattr(outs[j], key)[b]) == \
                    int(np.asarray(getattr(jo, key))[b]), (key, b, j)
            for key in ("t_wc", "R_fw"):
                np.testing.assert_allclose(
                    getattr(outs[j], key)[b].numpy(),
                    np.asarray(getattr(jo, key))[b], atol=ATOL_JAX,
                    rtol=ATOL_JAX / 10, err_msg=f"{key} {b} {j}")
            # JAX's batch against its own single-stream run
            np.testing.assert_allclose(
                np.asarray(jo.t_wc)[b],
                np.asarray(full["outs"][k + j].t_wc), atol=ATOL_JAX)


@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_vmapped_step_takes_no_per_stream_fallback(full, preset):
    """With vmap's fallback warning turned into an error, a batched step
    with a keyframe in it runs: every op of vo_step has a batching rule
    (the kernels' custom ops have theirs)."""
    cfg, states = _stream_states(full, preset)
    flag = torch._C._functorch._set_vmap_fallback_warning_enabled
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        flag(True)
        try:
            _, outs = _vmapped_run(full, cfg, states, n=2)
        finally:
            flag(False)
    assert any(bool(o.is_keyframe.any()) for o in outs)


def test_graphed_batch_body_equals_the_vmapped_step(full):
    """The body a card captures for vmapped_vo_step (the functional
    vmapped step, then every new stacked leaf written into the input's
    storage) equals vmapped_vo_step bit for bit over 3 steps with a
    keyframe in the batch, and keeps every stacked leaf's storage."""
    cfg, states = _stream_states(full, "fast")
    want_st, want = _vmapped_run(full, cfg, states)
    st = pytree.tree_map(torch.clone, streams.stack_states(states))
    ptrs = [x.data_ptr() for x in pytree.tree_leaves(st)]
    for j in range(N_STEPS):
        got_st, out = streams._vmapped_donated(
            st, _imgs(full, j), full["cam"], cfg, full["fh"].ncx,
            full["fh"].ncy, SHAPE)
        assert got_st is st
        assert all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(out), pytree.tree_leaves(want[j]))), j
        assert [x.data_ptr() for x in pytree.tree_leaves(st)] == ptrs
    assert any(bool(o.is_keyframe.any()) for o in want)
    assert all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(st), pytree.tree_leaves(want_st)))


def test_vmapped_step_builds_no_tensor_from_host_data(full):
    """The batched step (its graph's body) dispatches no ``lift_fresh``:
    no tensor made from host data, which on the card is a pageable copy
    that a CUDA graph's capture refuses."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    cfg, states = _stream_states(full, "fast")
    st = pytree.tree_map(torch.clone, streams.stack_states(states))
    imgs = _imgs(full, 0)
    with Log() as log:
        streams._vmapped_donated(st, imgs, full["cam"], cfg, full["fh"].ncx,
                                 full["fh"].ncy, SHAPE)
    assert len(log.ops) > 1000
    assert not [op for op in log.ops if "lift_fresh" in op]


def test_custom_ops_batch_like_the_plain_twins():
    """K1's and K2's custom ops under vmap on the CPU: one call for three
    streams, each equal to the plain twin on that stream (bit for bit: the
    op runs the same twin), with batched and shared arguments."""
    g = torch.Generator().manual_seed(0)
    B = 3
    pads = [build_padded_pyramid(torch.rand(SHAPE, generator=g) * 255, 5)
            for _ in range(B)]
    st = torch.stack([p.stack for p in pads])
    shapes = pads[0].shapes
    lv = torch.randint(0, 3, (B, 50), generator=g, dtype=torch.int32)
    x0 = torch.randint(-20, 330, (B, 50), generator=g, dtype=torch.int32)
    y0 = torch.randint(-20, 250, (B, 50), generator=g, dtype=torch.int32)
    t, xc, yc = torch.func.vmap(lambda s, l, x, y: tiles.gather_tiles(
        tiles.PaddedPyramid(s, shapes), l, x, y, 17, 17))(st, lv, x0, y0)
    t2, _, _ = torch.func.vmap(lambda s, x, y: tiles.gather_tiles(
        tiles.PaddedPyramid(s, shapes), lv[0], x, y, 8, 8))(st, x0, y0)
    for b in range(B):
        want = tiles.gather_tiles_plain(pads[b], lv[b], x0[b], y0[b], 17, 17)
        assert torch.equal(t[b], want[0])
        assert torch.equal(xc[b], want[1]) and torch.equal(yc[b], want[2])
        assert torch.equal(t2[b], tiles.gather_tiles_plain(
            pads[b], lv[0], x0[b], y0[b], 8, 8)[0])
    cam = reference_test_camera(SHAPE[1], SHAPE[0])
    N = 40
    px = torch.rand(B, N, 2, generator=g) * torch.tensor([300., 220.]) + 10
    f = cam.cam2world(px.reshape(-1, 2)).reshape(B, N, 3)
    d = torch.rand(B, N, generator=g) + 1.5
    v = torch.rand(B, N, generator=g) > 0.1
    T = TSE3.exp(torch.tensor([1e-3, -2e-3, 1e-3, 1e-3, 0.0, 0.0]))
    cur = st.roll(1, 0)
    out = torch.func.vmap(lambda r, c, p, ff, dd, vv: align_kernel._unpack(
        *align_kernel.sparse_align_op(
            r, c, T.R, T.t, p, ff, dd, vv, align_kernel._cam_list(cam),
            tiles._shapes_arg(shapes), 4, 2, 30, 1e-7)))(st, cur, px, f, d, v)
    for b in range(B):
        r = sparse_img_align_plain(pads[b], pads[(b - 1) % B], cam, T, px[b],
                                   f[b], d[b], v[b], 4, 2, 30, 1e-7)
        assert torch.equal(out[0].R[b], r.T_cur_ref.R)
        assert torch.equal(out[0].t[b], r.T_cur_ref.t)
        assert int(out[1][b]) == int(r.n_tracked)
        assert torch.equal(out[4][b], r.iters)
        assert int(r.n_tracked) > 0


def test_mesh_helpers_are_noops_without_an_axis(full):
    """shard_dim0, gather_dim0 and psum return their input for an empty
    axis, and the single-device step issues no collective."""
    x = (torch.arange(8), torch.ones(4, 3))
    for fn in (gspmd.shard_dim0, gspmd.gather_dim0, gspmd.psum):
        assert fn(x, "") is x
    s = state_from_numpy(jax_tree(full["states"][5]), device="cpu")
    with gspmd.record_collectives() as log:
        tfused.vo_step(s, to_torch(full["imgs"][5]), full["cam"],
                       full["tcfg"], full["fh"].ncx, full["fh"].ncy, SHAPE)
    assert log == []
    assert gspmd._LOGS == []


def test_entry_points_need_a_card_unless_given_the_cpu(full):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.init_multihost("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(jax_tree(full["states"][2]))
    # the batched step runs where its states are: the CPU when asked for
    cfg, states = _stream_states(full, "fast")
    st, out = streams.vmapped_vo_step(
        streams.stack_states(states[:2]), _imgs(full, 0)[:2], full["cam"],
        cfg, full["fh"].ncx, full["fh"].ncy, SHAPE)
    assert out.t_wc.device.type == "cpu" and out.t_wc.shape == (2, 3)
    # a mesh needs a process group: none falls back to one rank
    with pytest.raises(RuntimeError, match="process group"):
        sharded.make_mesh(device="cpu")


# --- the gloo world --------------------------------------------------------

def _ba_problem(rng, P: int, K: int = 4, M: int = 4) -> dict:
    """tests/test_ba.py's problem from numpy draws: cameras on a line at a
    point cloud, every point seen by the first M cameras, the first two
    cameras fixed, poses and points perturbed."""
    p_gt = (rng.uniform(-1, 1, (P, 3)) + [0, 0, 4]).astype(np.float32)
    Ts = [TSE3.exp(torch.tensor([0.4 * i, 0.02 * i, 0.0, 0.0, 0.05 * i,
                                 0.0])) for i in range(K)]
    R = torch.stack([T.R for T in Ts])
    t = torch.stack([T.t for T in Ts])
    oc = np.tile(np.arange(M, dtype=np.int32)[None], (P, 1))
    ocl = torch.from_numpy(oc).long()
    pc = torch.einsum("pmij,pj->pmi", R[ocl], torch.from_numpy(p_gt)) \
        + t[ocl]
    noise = rng.normal(0, 0.02, (K, 6)).astype(np.float32)
    noise[:2] = 0.0
    Tn = TSE3.exp(torch.from_numpy(noise)) * TSE3(R, t)
    var = np.ones(K, bool)
    var[:2] = False
    prob = dict(R=Tn.R.numpy(), t=Tn.t.numpy(), cam_variable=var,
                p_w=(p_gt + rng.normal(0, 0.02, (P, 3))).astype(np.float32),
                p_valid=np.ones(P, bool), obs_cam=oc,
                obs_f=(pc / pc.norm(dim=-1, keepdim=True)).numpy(),
                obs_level=np.zeros((P, M), np.int32),
                obs_mask=(pc[..., 2] > 0.1).numpy())
    return dict(prob=prob, t_gt=t.numpy(), p_gt=p_gt)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def world(full, tmp_path_factory):
    """The inputs, and every rank's results of the worker's tasks."""
    rng = np.random.default_rng(7)
    S = 128
    seed = dict(mu=rng.uniform(0.3, 0.8, S), z_range=np.full(S, 2.0),
                sigma2=np.where(rng.uniform(size=S) < 0.3, 2e-5, 0.05),
                a=np.full(S, 10.0), b=np.full(S, 10.0),
                tau2=np.full(S, 1e-3), active=rng.uniform(size=S) < 0.9)
    seed["x"] = seed["mu"] + rng.normal(0, 0.01, S)
    seed = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in seed.items()}
    p_w = (rng.uniform(-1, 1, (128, 3)) + [0, 0, 3]).astype(np.float32)
    T_gt = TSE3.exp(torch.tensor([0.2, -0.1, 0.05, 0.03, 0.02, -0.01]))
    f = T_gt.apply(torch.from_numpy(p_w))
    pose = dict(p_w=p_w, f=(f / f.norm(dim=-1, keepdim=True)).numpy(),
                level=rng.integers(0, 3, 128).astype(np.int32),
                valid=rng.uniform(size=128) < 0.95,
                R_gt=T_gt.R.numpy(), t_gt=T_gt.t.numpy())
    ba = {P: _ba_problem(rng, P) for P in (64, 128)}
    acc_cfg, acc = _port_run(full, "accurate", SCAN_FROM)
    scan = dict(shape=SHAPE, cfg_kw=FULL_KW, ncx=full["fh"].ncx,
                ncy=full["fh"].ncy,
                fast=dict(state=jax_tree(full["states"][SCAN_FROM]),
                          imgs=np.stack(full["imgs"][SCAN_FROM:SCAN_FROM
                                                     + SCAN_FRAMES])),
                accurate=dict(state=state_to_numpy(acc[SCAN_FROM]),
                              imgs=np.stack(full["imgs"][SCAN_FROM:SCAN_FROM
                                                         + SCAN_FRAMES])))
    stream_in = dict(states=[jax_tree(full["states"][k]) for k in STARTS],
                     imgs=[np.stack(full["imgs"][k:k + STREAM_FRAMES])
                           for k in STARTS])
    data = dict(seed=seed, pose=pose,
                ba={P: b["prob"] for P, b in ba.items()}, ba_iters=BA_ITERS,
                scan=scan, streams=stream_in, mh_ba=ba[64]["prob"])
    out = tmp_path_factory.mktemp("torch_parallel")
    with open(out / "in.pkl", "wb") as fh:
        pickle.dump(data, fh)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, str(WORLD), str(r),
         str(out / "in.pkl"), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    joined = "\n---\n".join(logs)
    for r, p in enumerate(procs):
        assert p.returncode == 0 and "WORKER_OK" in logs[r], \
            f"rank {r} rc={p.returncode}\n{joined[-6000:]}"
    res = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return dict(data=data, ba=ba, acc_cfg=acc_cfg, res=res)


def test_world_runs_on_gloo_with_one_rank_per_process(world):
    assert [r["rank"] for r in world["res"]] == list(range(WORLD))
    assert all(r["device"] == "cpu" for r in world["res"])


# a' = (e - f) / (f - e / f) in the seed update cancels e and f by up to
# 52x on the fixture's inputs, so the few float32 roundings of e and f
# (2**-24 each) move a' and b' by about 3.1e-6 relative apiece: both
# packages lie up to 6.96e-6 from the float64 update (measured), on
# either side.  2.5e-5 allows 8 such roundings.
SEED_AB_RTOL = 2.5e-5
SEED_TOL = {"mu": (1e-6, 0.0), "sigma2": (1e-6, 0.0),
            "a": (0.0, SEED_AB_RTOL), "b": (0.0, SEED_AB_RTOL)}


def test_sharded_seed_update_matches_jax(world):
    """Each rank's update and JAX's against the port's update evaluated in
    float64 on the same inputs (mu and sigma2 to 1e-6 absolute, a and b
    to SEED_AB_RTOL relative), and the two packages within the sum of
    their bounds."""
    sd = world["data"]["seed"]
    keys = ("mu", "sigma2", "a", "b", "z_range", "x", "tau2")
    jm = jseed_update(jmake_mesh(WORLD, dp=1), *[
        jnp.asarray(sd[k]) for k in keys + ("active",)])
    f64 = [torch.from_numpy(sd[k].astype(np.float64)) for k in keys]
    act = torch.from_numpy(sd["active"])
    ref = [torch.where(act, new, old).numpy() for new, old in
           zip(tdf.seed_variance_update(*f64), f64[:4])]
    for r in world["res"]:
        got = r["seed"]
        for name, a, b, want in zip(SEED_TOL, got["fields"], jm[:4], ref):
            atol, rtol = SEED_TOL[name]
            for x in (a, np.asarray(b)):
                np.testing.assert_allclose(x, want, atol=atol, rtol=rtol,
                                           err_msg=name)
            np.testing.assert_allclose(a, np.asarray(b), atol=2 * atol,
                                       rtol=2 * rtol, err_msg=name)
        assert got["n_conv"] == int(jm[4]) > 0
        # one all-reduce, for the convergence count
        assert [k for k, _ in got["raw"]] == ["all_reduce"]


def test_sharded_pose_optimize_matches_jax(world):
    pd = world["data"]["pose"]
    jT = jpose_opt(jmake_mesh(WORLD, dp=2), JSE3.identity(),
                   jnp.asarray(pd["p_w"]), jnp.asarray(pd["f"]),
                   jnp.asarray(pd["level"]), jnp.asarray(pd["valid"]),
                   n_iter=10)
    for r in world["res"]:
        got = r["pose"]
        assert got["rows"] == 128 // 2          # sp = 2
        np.testing.assert_allclose(got["t"], np.asarray(jT.t), atol=1e-5)
        np.testing.assert_allclose(got["R"], np.asarray(jT.R), atol=1e-5)
        assert np.linalg.norm(got["t"] - pd["t_gt"]) < 1e-3
        # one all-reduce of H, b and chi2 per GN iteration
        assert [k for k, _ in got["raw"]] == ["all_reduce"] * 10


def _prob(d) -> BAProblem:
    return BAProblem(*[torch.from_numpy(np.asarray(d[k]))
                       for k in BAProblem._fields])


def test_distributed_ba_matches_solve_ba_and_jax(world):
    for P, b in world["ba"].items():
        ref = solve_ba(_prob(b["prob"]), n_iter=BA_ITERS, huber_width=0.01)
        for r in world["res"]:
            got = r["ba"][P]
            np.testing.assert_allclose(got["t"], ref.t.numpy(), atol=5e-4)
            assert np.linalg.norm(got["t"] - b["t_gt"], axis=-1)[2:].max() \
                < 2e-3
            assert np.median(np.linalg.norm(got["p"] - b["p_gt"], axis=-1)) \
                < 2e-3
    b = world["ba"][64]
    jprob = JBAProblem(*[jnp.asarray(b["prob"][k])
                         for k in JBAProblem._fields])
    jR, jt, jp, _ = jba_solve(jmake_mesh(WORLD, dp=1), jprob,
                              n_iter=BA_ITERS, huber_width=0.01)
    got = world["res"][0]["ba"][64]
    np.testing.assert_allclose(got["t"], np.asarray(jt), atol=5e-4)
    np.testing.assert_allclose(got["p"], np.asarray(jp), atol=5e-4)


def test_distributed_ba_all_reduces_a_point_count_free_system(world):
    """Per GN iteration: one all-reduce of the reduced camera system and
    one of the rollback's chi2, plus the initial chi2; the system's bytes
    do not change when the points double."""
    sizes = {}
    for P in (64, 128):
        raw = world["res"][0]["ba"][P]["raw"]
        assert [k for k, _ in raw] == ["all_reduce"] * (1 + 2 * BA_ITERS)
        sizes[P] = [n for _, n in raw]
    assert sizes[64] == sizes[128]
    K = world["ba"][64]["prob"]["R"].shape[0]
    assert sizes[64][1] == (36 * K * K + 48 * K) * 4


@pytest.mark.parametrize("preset,sp", [("fast", 2), ("fast", 4),
                                       ("accurate", 2)])
def test_vo_scan_mesh_matches_the_single_rank_scan(world, full, preset, sp):
    sc = world["data"]["scan"]
    cfg = full["tcfg"] if preset == "fast" else world["acc_cfg"]
    s = state_from_numpy(sc[preset]["state"], device="cpu")
    _, outs = tfused.vo_scan(s, to_torch(sc[preset]["imgs"]), full["cam"],
                             cfg, sc["ncx"], sc["ncy"], SHAPE)
    for r in world["res"]:
        steps = r["scan"][(preset, sp)]
        assert len(steps) == len(outs.t_wc)
        for j, got in enumerate(steps):
            assert not got["failed"]
            assert got["is_keyframe"] == bool(outs.is_keyframe[j]), j
            np.testing.assert_allclose(got["t_wc"], outs.t_wc[j].numpy(),
                                       atol=1e-4, rtol=0)
    steps = world["res"][0]["scan"][(preset, sp)]
    kf = [s_ for s_ in steps if s_["is_keyframe"]]
    assert kf and all(s_["raw"] for s_ in kf), \
        "a keyframe step issued no collective"
    if preset == "accurate":
        # local BA's reduced system crosses the ranks at a keyframe
        assert max(len(s_["raw"]) for s_ in kf) > 2


def test_vo_scan_mesh_checks_df_update_k(world):
    assert world["res"][0]["scan_k90"].startswith("ValueError")


def test_multistream_scan_issues_no_collective(world, full):
    """One stream per rank over 2 hosts x 2 (global_mesh with inner size
    1, each rank's stream from its host's rows): no collective; each
    stream as its single-process run and within 2e-3 m of JAX's."""
    st = world["data"]["streams"]
    cfg = full["tcfg"]
    for r in world["res"]:
        got = r["streams"]
        assert got["mesh"] == (WORLD, 1)
        assert got["raw"] == [] and got["log"] == []
        b = got["stream"]
        s = state_from_numpy(st["states"][b], device="cpu")
        _, outs = tfused.vo_scan(s, to_torch(st["imgs"][b]), full["cam"],
                                 cfg, full["fh"].ncx, full["fh"].ncy, SHAPE)
        ref = outs.t_wc.numpy()
        assert not got["failed"].any()
        np.testing.assert_allclose(got["t_wc"][0], ref, atol=1e-6, rtol=0)
        k = STARTS[b]
        jax_t = np.stack([np.asarray(o.t_wc) for o in
                          full["outs"][k:k + STREAM_FRAMES]])
        assert np.abs(got["t_wc"][0] - jax_t).max() < 2e-3


def test_multihost_ba_solve_matches_solve_ba(world):
    b = world["ba"][64]
    ref = solve_ba(_prob(b["prob"]), n_iter=BA_ITERS, huber_width=0.01)
    for r in world["res"]:
        got = r["mh_ba"]
        assert got["mesh"] == (2, 2)
        np.testing.assert_allclose(got["t"], ref.t.numpy(), atol=5e-4)
        np.testing.assert_allclose(got["p"], ref.p_w.numpy(), atol=5e-4)
        assert [k for k, _ in got["raw"]] == ["all_reduce"] * (
            1 + 2 * BA_ITERS)
