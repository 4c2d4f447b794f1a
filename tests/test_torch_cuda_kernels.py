"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA card and skips elsewhere (marker ``cuda``).
The file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(tests/conftest.py configures JAX for the rest of the suite.)  The twins
are held against the JAX package on the CPU by the other
tests/test_torch_*.py files.  Tolerances: K1 copies, so bit-exact.  K2
sums in another order than its twin (which gathers with the plain
``gather_tiles_plain``, so no kernel under test computes the reference):
poses within 1e-5 m and 1e-5, the same tracked count and the same
iterations at every level.  The measured gap is about 2e-7.

The donated step as a CUDA graph (core/graphed.py) against the eager
step body over frames 81-100 of the bench scene: the same kernels in the
same order, so bit-equal in the fast preset and within 1e-5 m in the
accurate one (local BA's atomic sums); its capture under sync-debug
"error", no new capture for a state stepped again, and K1 and K2 counted
by the profiler's kernel events, which see a graph's replays.  The
entries that keep their input on the same frames: graphed ``vo_step``
against the eager body (input untouched, a clone finds the same slot),
and graphed ``vmapped_vo_step`` at B = 4 against the eager batched step.
FrameHandler's jitted stages (``graphed.jit``): each stage's replay
against its body under ``graphed.disable()`` on the arguments of a
handler keyframe frame (bit-equal but for local BA's atomic sums), no
capture for new values of a signature, the caller's inputs untouched, a
returned tensor the caller's own, a host sync or an in-place write of an
input in a body refused at capture, and the graphed handler against the
eager one over frames 81-100 (K1 and K2 as counted, graph replays
included, and as the profiler saw them).
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch.config import bench_cfg
from rpg_svo_tpu_torch.core import fused
from rpg_svo_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.ops import align_kernel, tiles
from rpg_svo_tpu_torch.ops.detector import grid_dims
from rpg_svo_tpu_torch.ops.pyramid import build_padded_pyramid
from rpg_svo_tpu_torch.ops.sparse_align import sparse_img_align_plain
from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset

from _torch_port import need_cuda

SHAPE = (480, 752)
CFG = bench_cfg("fast").replace(ablate=("kf", "df"))
K2_TOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    dev = need_cuda()
    ds = SyntheticDataset(n_frames=441, trajectory="circle", radius=0.25,
                          revolutions=0.5, shape=SHAPE, device=dev)
    img0, depth0, T0 = ds.frame(0)
    state0 = fused.seed_first_frame_with_depth(img0, T0.inverse(), depth0,
                                               ds.cam, CFG, img_shape=SHAPE,
                                               device=dev)
    return ds, state0


def _dispatched_ops(fn):
    """(result, names of the aten ops fn dispatches)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Log() as log:
        out = fn()
    return out, log.ops


def _device_kernels(fn):
    """Names of the kernels fn runs on the card (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _assert_twin(Tk, nk, ik, rp):
    """K2's pose, tracked count and iterations against its twin's."""
    assert float(torch.linalg.vector_norm(Tk.t - rp.T_cur_ref.t)) < K2_TOL
    assert float(torch.abs(Tk.R - rp.T_cur_ref.R).max()) < K2_TOL
    assert int(nk) == int(rp.n_tracked)
    assert torch.equal(ik.cpu(), rp.iters.cpu()), (ik, rp.iters)


def _eager(state, img, cam, cfg, ncx, ncy):
    """The step's eager body, out of place (every op from Python, its
    jitted stages too: ``graphed.disable()``): the reference of the
    graphed entries, and a card path whose launches the wrappers count."""
    from rpg_svo_tpu_torch.core import graphed
    with graphed.disable():
        return fused._vo_step(state, img, cam, cfg, ncx, ncy, SHAPE,
                              inplace=False)


@pytest.mark.cuda
@pytest.mark.parametrize("side", [8, 17, 24])
def test_tile_kernel_bit_exact_on_card(scene, side):
    """K1 against its twin, clamp included; one launch and no other device
    op per gather_tiles call (allocation and views only)."""
    ds, state0 = scene
    dev = state0.R.device
    pad = state0.pad
    rng = np.random.default_rng(side)
    n = 300
    lv = rng.integers(0, 5, n).astype(np.int32)
    W = np.asarray([w for _, w in pad.shapes])[lv]
    H = np.asarray([h for h, _ in pad.shapes])[lv]
    x0 = rng.integers(-20, W + 20).astype(np.int32)
    y0 = rng.integers(-20, H + 20).astype(np.int32)
    # the origins as strided views of one (N, 2) tensor, as callers pass
    xy = torch.from_numpy(np.stack([x0, y0], -1)).to(dev)
    args = (pad, torch.from_numpy(lv).to(dev), xy[:, 0], xy[:, 1], side,
            side)
    before = tiles.tile_gather_kernel.launches
    (tk, xk, yk), ops = _dispatched_ops(lambda: tiles.gather_tiles(*args))
    assert tiles.tile_gather_kernel.launches == before + 1
    assert set(ops) <= {"aten.empty.memory_format", "aten.select.int"}, ops
    kernels = _device_kernels(lambda: tiles.gather_tiles(*args))
    assert len(kernels) == 1 and "tile_gather_kernel" in kernels[0], kernels
    np.testing.assert_array_equal(xk.cpu().numpy(),
                                  np.clip(x0, 0, np.maximum(W - side, 0)))
    np.testing.assert_array_equal(yk.cpu().numpy(),
                                  np.clip(y0, 0, np.maximum(H - side, 0)))
    tp, xp, yp = tiles.gather_tiles_plain(*args)
    assert torch.equal(tk, tp) and torch.equal(xk, xp) and torch.equal(yk, yp)


@pytest.mark.cuda
@pytest.mark.parametrize("use,side,n", [
    ("reprojection, accurate", 17, 304), ("epipolar align2D", 17, 192),
    ("keyframe tiles, fast", 24, 128), ("keyframe tiles, accurate", 24, 256),
    ("seed detection tiles", 24, 384)])
def test_tile_kernel_bit_exact_at_the_call_sites(scene, use, side, n):
    """K1 against its twin at the shapes the whole step gives it (levels
    0-2), origins over and past every edge."""
    _, state0 = scene
    dev = state0.R.device
    pad = state0.pad
    rng = np.random.default_rng(n + side)
    lv = rng.integers(0, 3, n).astype(np.int32)
    W = np.asarray([w for _, w in pad.shapes])[lv]
    H = np.asarray([h for h, _ in pad.shapes])[lv]
    x0 = rng.integers(-20, W + 20).astype(np.int32)
    y0 = rng.integers(-20, H + 20).astype(np.int32)
    args = (pad, torch.from_numpy(lv).to(dev), torch.from_numpy(x0).to(dev),
            torch.from_numpy(y0).to(dev), side, side)
    tk, xk, yk = tiles.gather_tiles(*args)
    tp, xp, yp = tiles.gather_tiles_plain(*args)
    assert torch.equal(tk, tp) and torch.equal(xk, xp) and torch.equal(yk, yp)
    np.testing.assert_array_equal(xk.cpu().numpy(),
                                  np.clip(x0, 0, np.maximum(W - side, 0)))


@pytest.mark.cuda
def test_sparse_align_kernel_matches_twin_at_256_features(scene):
    """The accurate preset's 256-slot feature table (bench_cfg: grid 25,
    max_fts 200) on the frame 0/5 pair."""
    ds, _ = scene
    dev = torch.device("cuda")
    cfg = bench_cfg("accurate")
    img0, depth0, T0 = ds.frame(0)
    st = fused.seed_first_frame_with_depth(img0, T0.inverse(), depth0, ds.cam,
                                           cfg, img_shape=SHAPE, device=dev)
    assert st.feat_px.shape[0] == 256
    pad5 = build_padded_pyramid(ds.frame(5)[0], cfg.n_levels_total)
    pid = torch.clamp(st.feat_point, 0).long()
    depth = torch.linalg.vector_norm(
        SE3(st.R, st.t).apply(st.m.pt.pos[pid]), dim=-1)
    T_init = SE3.exp(torch.tensor([2e-3, -3e-3, 1e-3, 2e-3, -1e-3, 1e-3],
                                  device=dev))
    args = (st.pad, pad5, ds.cam, T_init, st.feat_px, st.feat_f, depth,
            st.feat_valid, cfg.klt_max_level, cfg.klt_min_level,
            cfg.img_align_n_iter, cfg.img_align_eps)
    Tk, nk, _, _, ik = align_kernel.sparse_align_kernel(*args)
    rp = sparse_img_align_plain(*args, gather=tiles.gather_tiles_plain)
    _assert_twin(Tk, nk, ik, rp)


@pytest.mark.cuda
def test_tile_kernel_rejects_malformed_inputs(scene):
    _, state0 = scene
    z = torch.zeros(4, dtype=torch.int64, device=state0.R.device)
    with pytest.raises(ValueError):
        tiles.tile_gather_kernel(state0.pad, z, z, z, 17, 17)


@pytest.mark.cuda
@pytest.mark.parametrize("max_level,min_level", [(4, 2), (3, 2), (2, 2)])
def test_sparse_align_kernel_matches_twin_on_card(scene, max_level,
                                                   min_level):
    """The whole alignment in one launch against sparse_img_align_plain on
    the frame 0/5 pair from a perturbed pose."""
    ds, state0 = scene
    dev = state0.R.device
    pad5 = build_padded_pyramid(ds.frame(5)[0], CFG.n_levels_total)
    pid = torch.clamp(state0.feat_point, 0).long()
    depth = torch.linalg.vector_norm(
        SE3(state0.R, state0.t).apply(state0.m.pt.pos[pid]), dim=-1)
    T_init = SE3.exp(torch.tensor([3e-3, -2e-3, 1e-3, 1e-3, 2e-3, -1e-3],
                                  device=dev))
    args = (state0.pad, pad5, ds.cam, T_init, state0.feat_px, state0.feat_f,
            depth, state0.feat_valid, max_level, min_level,
            CFG.img_align_n_iter, CFG.img_align_eps)
    before = align_kernel.sparse_align_kernel.launches
    Tk, nk, Hk, ck, ik = align_kernel.sparse_align_kernel(*args)
    assert align_kernel.sparse_align_kernel.launches == before + 1
    rp = sparse_img_align_plain(*args, gather=tiles.gather_tiles_plain)
    _assert_twin(Tk, nk, ik, rp)
    assert torch.isfinite(Hk).all()
    assert float(ck) <= float(rp.chi2) * 1.01 + 1e-3
    for level in range(max_level, min_level - 1, -1):
        assert 1 <= int(ik[level]) <= CFG.img_align_n_iter


@pytest.mark.cuda
@pytest.mark.parametrize("n_feats", [5, 259])
def test_sparse_align_kernel_splits_any_feature_count(scene, n_feats):
    """Feature counts that fill no pass (5) or leave one partly filled
    past the fast preset's 128 (259 = the frame's features repeated): the
    kernel against its twin."""
    ds, state0 = scene
    dev = state0.R.device
    pad5 = build_padded_pyramid(ds.frame(5)[0], CFG.n_levels_total)
    pid = torch.clamp(state0.feat_point, 0).long()
    depth = torch.linalg.vector_norm(
        SE3(state0.R, state0.t).apply(state0.m.pt.pos[pid]), dim=-1)
    idx = torch.arange(n_feats, device=dev) % depth.shape[0]
    T_init = SE3.exp(torch.tensor([2e-3, 1e-3, -2e-3, -1e-3, 1e-3, 2e-3],
                                  device=dev))
    args = (state0.pad, pad5, ds.cam, T_init, state0.feat_px[idx],
            state0.feat_f[idx], depth[idx], state0.feat_valid[idx],
            CFG.klt_max_level, CFG.klt_min_level, CFG.img_align_n_iter,
            CFG.img_align_eps)
    Tk, nk, _, _, ik = align_kernel.sparse_align_kernel(*args)
    rp = sparse_img_align_plain(*args, gather=tiles.gather_tiles_plain)
    _assert_twin(Tk, nk, ik, rp)


@pytest.mark.cuda
def test_sparse_align_kernel_refuses_features_beyond_shared_memory(scene):
    """600 B of shared memory per feature: 1000 features do not fit in
    one block, the entry point refuses them, and the next call runs."""
    ds, state0 = scene
    pad5 = build_padded_pyramid(ds.frame(5)[0], CFG.n_levels_total)
    depth = torch.ones(state0.feat_px.shape[0], device=state0.R.device)

    def align(n):
        idx = torch.arange(n, device=depth.device) % depth.shape[0]
        return align_kernel.sparse_align_kernel(
            state0.pad, pad5, ds.cam, SE3.identity(device=depth.device),
            state0.feat_px[idx], state0.feat_f[idx], depth[idx],
            state0.feat_valid[idx], 4, 2, 30, 1e-7)
    with pytest.raises(RuntimeError):
        align(1000)
    assert torch.isfinite(align(128)[0].t).all()


@pytest.mark.cuda
def test_step_on_card_matches_the_cpu_path(scene):
    """Two tracking steps on the card (K1, K2; the eager body, so the
    wrappers count every launch) and on the CPU (twins) from one state:
    the same matches, poses within 1e-4 m; one alignment launch and one K1
    launch per step."""
    ds, state0 = scene
    ncx, ncy = grid_dims(SHAPE[1], SHAPE[0], CFG.grid_size)
    g, c = state0, state_from_numpy(state_to_numpy(state0), device="cpu")
    launches = (tiles.tile_gather_kernel.launches,
                align_kernel.sparse_align_kernel.launches)
    for i in (1, 2):
        img = ds.frame(i)[0]
        g, og = _eager(g, img, ds.cam, CFG, ncx, ncy)
        c, oc = fused.vo_step(c, img.cpu(), ds.cam, CFG, ncx, ncy, SHAPE)
        assert int(og.n_matches) == int(oc.n_matches)
        assert not bool(og.failed)
        assert float(torch.linalg.vector_norm(og.t_wc.cpu() - oc.t_wc)) \
            < 1e-4
    assert tiles.tile_gather_kernel.launches == launches[0] + 2
    assert align_kernel.sparse_align_kernel.launches == launches[1] + 2


@pytest.mark.cuda
def test_whole_step_on_card_matches_the_cpu_path(scene):
    """Two whole fast steps (ablate=()) on the card (the eager body) and on
    the CPU from one state: equal matches and keyframe decisions, poses
    within 1e-4 m; four K1 launches and one alignment launch per step."""
    ds, _ = scene
    cfg = bench_cfg("fast")
    ncx, ncy = grid_dims(SHAPE[1], SHAPE[0], cfg.grid_size)
    img0, depth0, T0 = ds.frame(0)
    g = fused.seed_first_frame_with_depth(img0, T0.inverse(), depth0, ds.cam,
                                          cfg, img_shape=SHAPE,
                                          device=img0.device)
    c = state_from_numpy(state_to_numpy(g), device="cpu")
    launches = (tiles.tile_gather_kernel.launches,
                align_kernel.sparse_align_kernel.launches)
    for i in (1, 2):
        img = ds.frame(i)[0]
        g, og = _eager(g, img, ds.cam, cfg, ncx, ncy)
        c, oc = fused.vo_step(c, img.cpu(), ds.cam, cfg, ncx, ncy, SHAPE)
        assert int(og.n_matches) == int(oc.n_matches)
        assert bool(og.is_keyframe) == bool(oc.is_keyframe)
        assert float(torch.linalg.vector_norm(og.t_wc.cpu() - oc.t_wc)) \
            < 1e-4
    assert tiles.tile_gather_kernel.launches == launches[0] + 8
    assert align_kernel.sparse_align_kernel.launches == launches[1] + 2


# --- stream batches (torch.func.vmap, parallel/streams.py) -----------------

def _frame_pads(ds, n: int):
    return [build_padded_pyramid(ds.frame(i)[0], CFG.n_levels_total)
            for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
def test_batched_tile_kernel_bit_exact_per_stream(scene, B):
    """K1 under vmap: one launch for B streams (each its own frame's stack
    and requests), every stream bit-exact with the twin on its own."""
    ds, state0 = scene
    dev = state0.R.device
    pads = _frame_pads(ds, B)
    shapes = pads[0].shapes
    rng = np.random.default_rng(B)
    n = 192
    lv = rng.integers(0, 3, (B, n)).astype(np.int32)
    W = np.asarray([w for _, w in shapes])[lv]
    H = np.asarray([h for h, _ in shapes])[lv]
    x0 = torch.from_numpy(rng.integers(-20, W + 20).astype(np.int32)).to(dev)
    y0 = torch.from_numpy(rng.integers(-20, H + 20).astype(np.int32)).to(dev)
    lvt = torch.from_numpy(lv).to(dev)
    stacks = torch.stack([p.stack for p in pads])
    before = tiles.tile_gather_kernel.launches
    tk, xk, yk = torch.func.vmap(lambda s, l, x, y: tiles.gather_tiles(
        tiles.PaddedPyramid(s, shapes), l, x, y, 17, 17))(stacks, lvt, x0, y0)
    assert tiles.tile_gather_kernel.launches == before + 1
    for b in range(B):
        tp, xp, yp = tiles.gather_tiles_plain(pads[b], lvt[b], x0[b], y0[b],
                                              17, 17)
        assert torch.equal(tk[b], tp) and torch.equal(xk[b], xp) \
            and torch.equal(yk[b], yp), b
    if B == 1:
        # one stream: what the unbatched launch computes
        tu, xu, yu = tiles.gather_tiles(pads[0], lvt[0], x0[0], y0[0], 17, 17)
        assert torch.equal(tk[0], tu) and torch.equal(xk[0], xu) \
            and torch.equal(yk[0], yu)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_batched_sparse_align_kernel_matches_twin_per_stream(scene, B,
                                                             preset):
    """K2 under vmap: one launch, one block per stream; stream b aligns the
    frame-0 features (rolled by b) against frame 3 + b from its own
    perturbed pose, with the reference pyramid shared (stream stride 0):
    each stream against sparse_img_align_plain on its own, at N = 128
    (fast) and N = 256 (accurate)."""
    ds, _ = scene
    dev = torch.device("cuda")
    cfg = bench_cfg(preset)
    img0, depth0, T0 = ds.frame(0)
    st = fused.seed_first_frame_with_depth(img0, T0.inverse(), depth0, ds.cam,
                                           cfg, img_shape=SHAPE, device=dev)
    N = st.feat_px.shape[0]
    assert N == {"fast": 128, "accurate": 256}[preset]
    pid = torch.clamp(st.feat_point, 0).long()
    depth = torch.linalg.vector_norm(
        SE3(st.R, st.t).apply(st.m.pt.pos[pid]), dim=-1)
    rng = np.random.default_rng(B + N)
    xi = torch.tensor(rng.normal(0, [3e-3] * 3 + [2e-3] * 3, (B, 6)),
                      dtype=torch.float32, device=dev)
    T_init = SE3.exp(xi)
    curs = torch.stack([build_padded_pyramid(ds.frame(3 + b)[0],
                                             cfg.n_levels_total).stack
                        for b in range(B)])
    roll = lambda a: torch.stack([torch.roll(a, b, 0)  # noqa: E731
                                  for b in range(B)])
    feats = (roll(st.feat_px), roll(st.feat_f), roll(depth),
             roll(st.feat_valid))
    shapes = st.pad.shapes
    lv = (cfg.klt_max_level, cfg.klt_min_level, cfg.img_align_n_iter,
          cfg.img_align_eps)

    def one(cur, R, t, px, f, d, v):
        return align_kernel.sparse_align_kernel(
            st.pad, tiles.PaddedPyramid(cur, shapes), ds.cam, SE3(R, t), px,
            f, d, v, *lv)
    before = align_kernel.sparse_align_kernel.launches
    Tk, nk, Hk, ck, ik = torch.func.vmap(one)(curs, T_init.R, T_init.t,
                                              *feats)
    assert align_kernel.sparse_align_kernel.launches == before + 1
    for b in range(B):
        rp = sparse_img_align_plain(
            st.pad, tiles.PaddedPyramid(curs[b], shapes), ds.cam,
            SE3(T_init.R[b], T_init.t[b]), *[a[b] for a in feats], *lv,
            gather=tiles.gather_tiles_plain)
        _assert_twin(SE3(Tk.R[b], Tk.t[b]), nk[b], ik[b], rp)
        assert torch.isfinite(Hk[b]).all() and bool(torch.isfinite(ck[b]))
    if B == 1:
        # one stream: what the unbatched launch computes, bit for bit
        Tu, nu, Hu, cu, iu = one(curs[0], T_init.R[0], T_init.t[0],
                                 *[a[0] for a in feats])
        assert torch.equal(Tk.R[0], Tu.R) and torch.equal(Tk.t[0], Tu.t)
        assert torch.equal(Hk[0], Hu) and torch.equal(ik[0], iu)
        assert int(nk[0]) == int(nu)


# --- the donated step as one CUDA graph (core/graphed.py) -------------------
GRAPH_FROM = 80        # eager vo_step to here, then frames 81-100 both ways
GRAPH_FRAMES = 20      # the window holds the bench scene's keyframe 87
GRAPH_ACC_TOL_M = 1e-5  # local BA's index_add_ atomics sum in any order


STREAM_EVERY = 10      # the batch of streams starts from every 10th frame


def _clone_state(state):
    return pytree.tree_map(torch.clone, state)



def _kernel_events(fn):
    """(K1, K2) kernel events on the card during fn (torch.profiler's raw
    events, as chip_smoke._device_totals reads them)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    return (sum("tile_gather_kernel" in n for n in names),
            sum("sparse_align_kernel" in n for n in names))


@pytest.fixture(scope="module")
def graph_runs(scene):
    """Per preset: the bench scene's eager step body from its seeding to
    frame GRAPH_FROM (that state kept, and every STREAM_EVERY-th), its
    outputs over the next GRAPH_FRAMES frames, and the graphed
    vo_scan_donated over the same frames from a clone of the kept
    state."""
    from rpg_svo_tpu_torch.core import graphed
    ds, _ = scene
    dev = need_cuda()
    graphed.clear()
    # a profile before any capture: CUPTI is set up when the graphs are made
    _kernel_events(lambda: torch.zeros(1, device=dev).add_(1))
    imgs = [ds.frame(i)[0] for i in range(GRAPH_FROM + GRAPH_FRAMES + 1)]
    img0, depth0, T0 = ds.frame(0)
    out = {}
    for preset in ("fast", "accurate"):
        cfg = bench_cfg(preset)
        ncx, ncy = grid_dims(SHAPE[1], SHAPE[0], cfg.grid_size)
        st = fused.seed_first_frame_with_depth(img0, T0.inverse(), depth0,
                                               ds.cam, cfg, img_shape=SHAPE,
                                               device=dev)
        snaps = {}
        for i in range(1, GRAPH_FROM + 1):
            st, _ = _eager(st, imgs[i], ds.cam, cfg, ncx, ncy)
            if i % STREAM_EVERY == 0:
                snaps[i] = st
        start = _clone_state(st)
        eager = []
        for i in range(GRAPH_FROM + 1, GRAPH_FROM + GRAPH_FRAMES + 1):
            st, o = _eager(st, imgs[i], ds.cam, cfg, ncx, ncy)
            eager.append(o)
        gst, graphed_outs = fused.vo_scan_donated(
            _clone_state(start), imgs[GRAPH_FROM + 1:], ds.cam, cfg, ncx,
            ncy, SHAPE)
        out[preset] = dict(cfg=cfg, cam=ds.cam, grid=(ncx, ncy), start=start,
                           eager=eager, graphed=graphed_outs, state=gst,
                           imgs=imgs, snaps=snaps)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_graphed_donated_scan_equals_eager_vo_step(graph_runs, preset):
    """vo_scan_donated on the card (one capture, then replays) over frames
    81-100 against the eager step body: the same kernels in the same
    order, so bit-equal poses in the fast preset and within 1e-5 m in the
    accurate one (local BA's atomic sums); the same keyframes (87 among
    them)."""
    r = graph_runs[preset]
    kf_e = [i for i, o in enumerate(r["eager"], GRAPH_FROM + 1)
            if bool(o.is_keyframe)]
    graphed_outs = r["graphed"]        # one StepOut stacked along T
    assert graphed_outs.t_wc.shape == (GRAPH_FRAMES, 3)
    kf_g = [GRAPH_FROM + 1 + i for i, k in
            enumerate(graphed_outs.is_keyframe.tolist()) if k]
    assert kf_g == kf_e and 87 in kf_g, (kf_g, kf_e)
    for j, e in enumerate(r["eager"]):
        g = fused.StepOut(*(x[j] for x in graphed_outs))
        assert not bool(g.failed)
        assert int(e.n_matches) == int(g.n_matches)
        if preset == "fast":
            assert torch.equal(e.t_wc, g.t_wc) and torch.equal(e.R_fw, g.R_fw)
        else:
            assert float(torch.abs(e.t_wc - g.t_wc).max()) <= GRAPH_ACC_TOL_M


@pytest.mark.cuda
def test_second_call_with_the_same_state_makes_no_capture(graph_runs):
    """The scan's state keeps the storage of every leaf, so stepping it
    again replays the scan's graph (no new graph); a clone of it is
    another key, and its first step captures another graph."""
    from rpg_svo_tpu_torch.core import graphed
    r = graph_runs["fast"]
    ncx, ncy = r["grid"]
    st = r["state"]
    ptrs = [x.data_ptr() for x in pytree.tree_leaves(st)]
    n = len(graphed.graphs())
    st2, _ = fused.vo_step_donated(st, r["imgs"][1], r["cam"], r["cfg"],
                                   ncx, ncy, SHAPE)
    assert st2 is st and len(graphed.graphs()) == n
    assert [x.data_ptr() for x in pytree.tree_leaves(st)] == ptrs
    fused.vo_step_donated(_clone_state(st), r["imgs"][2], r["cam"], r["cfg"],
                          ncx, ncy, SHAPE)
    assert len(graphed.graphs()) == n + 1


@pytest.mark.cuda
def test_graph_replay_launches_each_kernel(graph_runs):
    """A capture call launches K1 four times and K2 once (its eager step,
    every stage masked; the capture launches nothing); a replay launches
    K2 once and K1 once outside the mapping stages' IF nodes, and inside
    them on the frames that run them (the gate counters), as many as the
    profiler's kernel events; the wrappers count no replay, and graphed
    counts each replay's launches."""
    from rpg_svo_tpu_torch.core import graphed
    r = graph_runs["fast"]
    ncx, ncy = r["grid"]
    st = _clone_state(r["start"])
    counts = (tiles.tile_gather_kernel.launches,
              align_kernel.sparse_align_kernel.launches)
    graphed.reset_jit_counts()

    def step(i):
        return lambda: fused.vo_step_donated(st, r["imgs"][i], r["cam"],
                                             r["cfg"], ncx, ncy, SHAPE)
    assert _kernel_events(step(GRAPH_FROM + 1)) == (4, 1)
    assert (tiles.tile_gather_kernel.launches,
            align_kernel.sparse_align_kernel.launches) \
        == (counts[0] + 4, counts[1] + 1)
    assert graphed.replayed_launches() == {}
    for i in range(GRAPH_FROM + 2, GRAPH_FROM + GRAPH_FRAMES + 1):
        before = graphed.replayed_launches()
        ran = {k: v["ran"] for k, v in graphed.gate_stats().items()}
        ev = _kernel_events(step(i))
        rep = graphed.replayed_launches()
        now = {k: v["ran"] - ran[k] for k, v in graphed.gate_stats().items()}
        assert ev == (rep["tile_gather"] - before.get("tile_gather", 0),
                      rep["sparse_align"] - before.get("sparse_align", 0))
        assert ev == (1 + now["depth_filter"] + 2 * now["keyframe"], 1), \
            (i, ev, now)
    assert (tiles.tile_gather_kernel.launches,
            align_kernel.sparse_align_kernel.launches) \
        == (counts[0] + 4, counts[1] + 1)
    assert graphed.gate_stats()["keyframe"]["ran"] > 0


@pytest.mark.cuda
def test_graph_capture_runs_under_sync_debug_error(graph_runs):
    """The step's capture passes under the caller's sync-debug "error"
    mode; a step that reads a value back raises in its capture (no eager
    fallback), keeps no graph and restores the caller's mode."""
    from collections import namedtuple
    from rpg_svo_tpu_torch.core import graphed
    r = graph_runs["accurate"]
    ncx, ncy = r["grid"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused.vo_step_donated(_clone_state(r["start"]), r["imgs"][1],
                              r["cam"], r["cfg"], ncx, ncy, SHAPE)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    Out = namedtuple("Out", "total")

    def reads_back(state, img):
        state.add_(float(img.sum()))
        return state, Out(state.sum())
    x = torch.zeros(4, device=r["imgs"][1].device)
    n = len(graphed.graphs())
    with pytest.raises(RuntimeError):
        graphed.run(reads_back, ("reads_back",), x, r["imgs"][1])
    assert len(graphed.graphs()) == n
    assert torch.cuda.get_sync_debug_mode() == 0


# --- the entries that keep their input (core/graphed.run_kept) --------------
def _graphed_counts():
    from rpg_svo_tpu_torch.core import graphed
    return len(graphed.graphs()), len(graphed.slots())


def _t_wc_gap(a, b) -> float:
    return float(torch.abs(a.t_wc - b.t_wc).max())


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_graphed_vo_step_equals_the_eager_body(graph_runs, preset):
    """vo_step on the card (a copy into its slot, a replay of the donated
    step's graph, a copy out) over frames 81-100 against the eager step
    body: fast bit-equal, accurate within 1e-5 m, the same keyframes (87
    among them); its input state is left bit for bit as it was."""
    r = graph_runs[preset]
    ncx, ncy = r["grid"]
    st = r["start"]
    before = _clone_state(st)
    outs = []
    for i in range(GRAPH_FROM + 1, GRAPH_FROM + GRAPH_FRAMES + 1):
        new, o = fused.vo_step(st, r["imgs"][i], r["cam"], r["cfg"], ncx,
                               ncy, SHAPE)
        if i == GRAPH_FROM + 1:
            assert all(torch.equal(a, b) for a, b in zip(
                pytree.tree_leaves(before), pytree.tree_leaves(st)))
        st = new
        outs.append(o)
    kf = [i for i, o in enumerate(outs, GRAPH_FROM + 1)
          if bool(o.is_keyframe)]
    kf_e = [i for i, o in enumerate(r["eager"], GRAPH_FROM + 1)
            if bool(o.is_keyframe)]
    assert kf == kf_e and 87 in kf, (kf, kf_e)
    for e, g in zip(r["eager"], outs):
        assert not bool(g.failed) and int(e.n_matches) == int(g.n_matches)
        if preset == "fast":
            assert torch.equal(e.t_wc, g.t_wc) and torch.equal(e.R_fw, g.R_fw)
        else:
            assert _t_wc_gap(e, g) <= GRAPH_ACC_TOL_M


@pytest.mark.cuda
def test_second_vo_step_call_on_a_clone_makes_no_capture(graph_runs):
    """A state of the same shapes in other storage (a clone) finds the
    slot of the first: vo_step makes no graph and no slot, and gives the
    same result."""
    r = graph_runs["fast"]
    ncx, ncy = r["grid"]
    img = r["imgs"][GRAPH_FROM + 1]
    _, first = fused.vo_step(r["start"], img, r["cam"], r["cfg"], ncx, ncy,
                             SHAPE)
    counts = _graphed_counts()
    _, again = fused.vo_step(_clone_state(r["start"]), img, r["cam"],
                             r["cfg"], ncx, ncy, SHAPE)
    assert _graphed_counts() == counts
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_graphed_vmapped_step_matches_the_eager_batch(graph_runs):
    """vmapped_vo_step at B = 4 on the card (one graph for B's slot) over
    10 frames from the states after frames 50, 60, 70 and 80: each stream
    within 1e-5 m of the eager batched step with the same keyframes (87 in
    the last); a replayed batched step runs 1 K2 kernel and 1-4 K1 (the
    mapping stages' K1 only in steps where a stream runs them), as many
    as graphed counts, by the profiler's events, and waits on the card
    nowhere (sync-debug "error")."""
    from rpg_svo_tpu_torch.parallel import streams
    r = graph_runs["fast"]
    ncx, ncy = r["grid"]
    starts = [GRAPH_FROM - STREAM_EVERY * k for k in (3, 2, 1, 0)]
    sg = se = streams.stack_states([r["snaps"][k] for k in starts])
    kf_g, kf_e = [], []
    for j in range(1, STREAM_EVERY + 1):
        imgs = torch.stack([r["imgs"][k + j] for k in starts])
        sg, og = streams.vmapped_vo_step(sg, imgs, r["cam"], r["cfg"], ncx,
                                         ncy, SHAPE)
        se, oe = streams._vmapped_step(se, imgs, r["cam"], r["cfg"], ncx,
                                       ncy, SHAPE)
        assert not bool(og.failed.any())
        assert _t_wc_gap(og, oe) <= GRAPH_ACC_TOL_M, j
        kf_g.append(og.is_keyframe.tolist())
        kf_e.append(oe.is_keyframe.tolist())
    assert kf_g == kf_e and any(row[-1] for row in kf_g), kf_g
    imgs = torch.stack([r["imgs"][k + STREAM_EVERY + 1] for k in starts])

    def step():
        return streams.vmapped_vo_step(sg, imgs, r["cam"], r["cfg"], ncx,
                                       ncy, SHAPE)
    from rpg_svo_tpu_torch.core import graphed
    before = graphed.replayed_launches()
    ev = _kernel_events(step)
    rep = graphed.replayed_launches()
    assert ev[1] == 1 and 1 <= ev[0] <= 4, ev
    assert ev == (rep["tile_gather"] - before["tile_gather"],
                  rep["sparse_align"] - before["sparse_align"])
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")


# --- FrameHandler's jitted stages (core/graphed.jit) ------------------------
STAGE_FROM = 80        # the fast handler to here, then its keyframe frame 87


@pytest.fixture(scope="module")
def stage_calls(scene):
    """The fast FrameHandler from ground-truth depth to frame STAGE_FROM
    (graphed), then the arguments of every jitted stage called from the
    host over frames STAGE_FROM+1 .. the first keyframe, a global BA and a
    relocalization (a blank frame, then the next), each recorded on its
    first call: {name: (function, args, kwargs)}."""
    import copy
    from rpg_svo_tpu_torch.core import graphed
    from rpg_svo_tpu_torch.core.pipeline import FrameHandler
    ds, _ = scene
    dev = need_cuda()
    cfg = bench_cfg("fast")
    fh = FrameHandler(ds.cam, cfg, SHAPE, device=dev)
    img0, depth0, T0 = ds.frame(0)
    fh.set_first_frame_with_depth(img0, T0.inverse(), depth0)
    imgs = [ds.frame(i)[0] for i in range(STAGE_FROM + 21)]
    for i in range(1, STAGE_FROM + 1):
        fh.add_image(imgs[i], i / 50.0)
    start = copy.copy(fh)
    start.log = []
    calls = {}
    orig = graphed.Jitted.__call__

    def record(self, *args, **kwargs):
        if not graphed._flag("tracing") and not graphed._flag("disabled"):
            calls.setdefault(self.__qualname__, (self, args, kwargs))
        return orig(self, *args, **kwargs)
    graphed.Jitted.__call__ = record
    try:
        i = STAGE_FROM
        while "init_seeds" not in calls:
            i += 1
            fh.add_image(imgs[i], i / 50.0)
        fh.global_ba()
        fh.add_image(torch.zeros(SHAPE, device=dev), 0.0)
        fh.add_image(imgs[i + 1], (i + 1) / 50.0)
    finally:
        graphed.Jitted.__call__ = orig
    assert "sparse_img_align_raw" in calls, sorted(calls)
    return dict(calls=calls, start=start, imgs=imgs, cfg=cfg, fh=fh)


def _leaves_equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "sparse_img_align", "project_points", "candidate_bookkeeping",
    "grid_select", "match_cells", "optimize_pose", "_structure_opt",
    "_kf_policy", "update_seeds", "init_seeds", "sparse_img_align_raw"])
def test_graphed_stage_equals_its_body(stage_calls, name):
    """Each jitted stage of a handler keyframe frame (and relocalization's
    alignment) replayed on the card equals its body run eagerly under
    graphed.disable() on the same arguments, bit for bit; the replay
    leaves its inputs as they were."""
    from rpg_svo_tpu_torch.core import graphed
    f, args, kwargs = stage_calls["calls"][name]
    before = [x.clone() for x in pytree.tree_leaves((args, kwargs))
              if isinstance(x, torch.Tensor)]
    got = f(*args, **kwargs)
    with graphed.disable():
        want = f(*args, **kwargs)
    after = [x for x in pytree.tree_leaves((args, kwargs))
             if isinstance(x, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert _leaves_equal(got, want), name


@pytest.mark.cuda
def test_graphed_bundle_adjustments_equal_their_bodies(stage_calls):
    """Global BA (the handler's call), local BA (the accurate preset's)
    and two-view BA on the fast handler's map: replays bit-equal to their
    bodies (the per-camera sums are one-hot matmuls, which sum in one
    order every run)."""
    from rpg_svo_tpu_torch.core import graphed
    from rpg_svo_tpu_torch.core.local_ba import (
        run_local_ba, run_two_view_ba)
    fh = stage_calls["fh"]
    acc = bench_cfg("accurate")
    act = torch.nonzero(fh.map.kf.active).reshape(-1)
    s0, s1 = act[0], act[-1]
    cases = [
        (run_local_ba, (fh.map, s1, acc.loba_robust_huber_width,
                        acc.loba_thresh, fh.cam.fx),
         dict(n_iter=acc.loba_num_iter, core_n_kfs=acc.core_n_kfs)),
        (run_two_view_ba, (fh.map, s0, s1, acc.loba_robust_huber_width,
                           acc.loba_thresh, fh.cam.fx),
         dict(n_iter=acc.loba_num_iter)),
        stage_calls["calls"]["run_global_ba"]]
    for f, args, kw in cases:
        f(*args, **kw)
        got = f(*args, **kw)
        with graphed.disable():
            want = f(*args, **kw)
        assert _leaves_equal(got, want), f.__qualname__
        assert f.captures >= 1 and f.replays >= 2, f.stats()


@pytest.mark.cuda
def test_stage_with_new_values_makes_no_capture_and_owns_no_output(
        stage_calls):
    """optimize_pose called again with other values of the same shapes
    makes no capture and equals its body on them; a tensor it returned,
    written by the caller, changes nothing in the next call."""
    from rpg_svo_tpu_torch.core import graphed
    f, args, kwargs = stage_calls["calls"]["optimize_pose"]
    first = f(*args, **kwargs)
    caps = f.captures
    T, p_w = args[0], args[1]
    moved = (SE3(T.R, T.t + 1e-3),) + (p_w * 1.001,) + tuple(args[2:])
    got = f(*moved, **kwargs)
    assert f.captures == caps
    with graphed.disable():
        want = f(*moved, **kwargs)
    assert _leaves_equal(got, want)
    first.T_f_w.t.fill_(7.0)
    again = f(*args, **kwargs)
    assert not bool((again.T_f_w.t == 7.0).all())
    with graphed.disable():
        assert _leaves_equal(again, f(*args, **kwargs))


@pytest.mark.cuda
def test_capture_refuses_a_host_sync():
    """A jitted body that reads a value back to the host (.item()) runs
    eagerly, but its capture raises under sync-debug "error"; the mode is
    restored and no graph is kept."""
    from rpg_svo_tpu_torch.core import graphed
    dev = need_cuda()

    @graphed.jit
    def reads_back(x):
        return x * float(x.sum().item())

    x = torch.arange(4.0, device=dev)
    with graphed.disable():
        assert torch.equal(reads_back(x), x * 6.0)
    with pytest.raises(RuntimeError):
        reads_back(x)
    assert torch.cuda.get_sync_debug_mode() == 0
    assert reads_back.stats()["graphs"] == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_capture_refuses_a_body_that_writes_its_input():
    """A jitted body that writes a tensor argument in place raises at
    capture (a replay would write its input buffer, not the caller's
    tensor) and keeps no graph."""
    from rpg_svo_tpu_torch.core import graphed
    dev = need_cuda()

    @graphed.jit
    def writes(x):
        return x.mul_(2.0)

    x = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="in place"):
        writes(x)
    assert writes.stats()["graphs"] == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_graphed_handler_equals_the_eager_handler(stage_calls):
    """The fast handler over frames 81-100 (keyframe 87) from the same
    start, graphed and under graphed.disable(): bit-equal poses, the same
    results and keyframes, the same K1 and K2 kernel events (the
    profiler's), no capture in the graphed run (every stage was captured
    before), and no more host syncs (sync-debug "warn" counts)."""
    import copy
    import warnings
    from rpg_svo_tpu_torch.core import graphed
    r = stage_calls

    def run(disabled):
        h = copy.copy(r["start"])
        h.log = []
        with (graphed.disable() if disabled else contextlib.nullcontext()):
            infos = [h.add_image(r["imgs"][j], j / 50.0)
                     for j in range(STAGE_FROM + 1, STAGE_FROM + 21)]
        return infos, h.last_frame.T_f_w.t.clone()
    run(False)
    caps = sum(v["captures"] for v in graphed.jit_stats().values())
    gi, gt = run(False)
    assert sum(v["captures"] for v in graphed.jit_stats().values()) == caps
    ei, et = run(True)
    assert torch.equal(gt, et)
    assert [i["result"] for i in gi] == [i["result"] for i in ei]
    assert any(i.get("is_keyframe") for i in gi)

    def launches(disabled):
        """(K1, K2) as counted (the wrappers' own and the graph replays'),
        and as the profiler saw them: never more."""
        before = (tiles.tile_gather_kernel.launches,
                  align_kernel.sparse_align_kernel.launches)
        graphed.reset_jit_counts()
        seen = _kernel_events(lambda: run(disabled))
        rep = graphed.replayed_launches()
        counted = (tiles.tile_gather_kernel.launches - before[0]
                   + rep.get("tile_gather", 0),
                   align_kernel.sparse_align_kernel.launches - before[1]
                   + rep.get("sparse_align", 0))
        assert seen[0] <= counted[0] and seen[1] <= counted[1]
        return counted, seen
    (g_counted, g_seen), (e_counted, e_seen) = launches(False), launches(True)
    assert g_counted == e_counted and min(g_counted) > 0
    assert g_seen == e_seen, (g_seen, e_seen, g_counted)

    def syncs(disabled):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run(disabled)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(x.message) for x in w)
    assert syncs(False) <= syncs(True)
