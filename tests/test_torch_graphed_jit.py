"""``core/graphed.jit``, the port's ``jax.jit``, on the CPU.

A guard reads every ``jax.jit`` application of ``rpg_svo_tpu/`` by AST
and holds the port's counterpart to a ``graphed.jit`` wrapper with the
same static names.  On the CPU and under ``torch.func.vmap`` a wrapped
function runs its body and builds no graph; the graph key follows the
static arguments and the leaves' shapes and dtypes, not their values.  The
replay machinery (input buffers, copies out, outputs passed through,
eviction, a body that writes its input refused, the kernel launches a
replay counts) runs here on a stand-in graph whose replay reruns the body
on the buffers, and a handler run shows that no wrapped body dispatches an
op a capture refuses (a tensor from host data, a data-dependent shape) or
writes one of its inputs, and that every stage keeps one signature over
the frames.  The card's own
captures are ``tests/test_torch_cuda_kernels.py``'s.
"""

import ast
import collections
import contextlib
import importlib
import pathlib

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch.core import graphed
from rpg_svo_tpu_torch.core.pipeline import FrameHandler
from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.ops import homography as thom
from rpg_svo_tpu_torch.ops import point_opt, pose_opt
from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset

from _torch_port import FULL_KW, FULL_SCENE, SHAPE

ROOT = pathlib.Path(__file__).resolve().parents[1]

# jax.jit sites the port does not wrap with graphed.jit, each with its
# reason: (file, jitted name)
NOT_WRAPPED = {
    ("core/fused.py", "_vo_step"):
        "vo_step / vo_step_donated: graphed.run / run_kept (the fused "
        "entries' own graphs)",
    ("core/fused.py", "_vo_scan"):
        "vo_scan / vo_scan_donated: one slot and one graph per frame",
    ("parallel/streams.py", "vmapped_vo_step"):
        "graphed.run_kept over the functional vmap, one slot per B",
    ("ops/pallas_tiles.py", "_gather"):
        "K1's launch, one kernel already (ops/tiles.py)",
}
# the port's counterparts where the name differs or there are more than
# one: (file, jitted name) -> [(port file, port name)]
COUNTERPARTS = {
    ("ops/sparse_align.py", "sparse_img_align"): [
        ("ops/sparse_align.py", "sparse_img_align"),
        ("ops/sparse_align.py", "sparse_img_align_raw")],
    ("parallel/ba.py", "<jit in distributed_ba_solve>"): [
        ("parallel/ba.py", "distributed_ba_solve")],
    ("utils/synthetic.py", "<jit in SurfaceDataset.__init__>"): [
        ("utils/synthetic.py", "_render_surface")],
    ("utils/synthetic.py", "<jit in SyntheticDataset.__init__>"): [
        ("utils/synthetic.py", "_render_plane")],
}
# static names where a JAX site jits a closure: the port wraps the
# function whose Python arguments the closure holds
CLOSURE_STATIC = {
    ("parallel/ba.py", "distributed_ba_solve"):
        {"mesh", "n_iter", "axis", "n_var_max"},
}
# JAX static names with no parameter in the port, each with its reason
NO_PARAMETER = {
    "unroll": "an XLA loop-unroll factor (Config.img_align_unroll)",
    "use_kernel": "a switch between K2 and its plain twin; the port has "
                  "no switch that puts a plain version in a kernel's place",
    "img_shape0": "the level-0 shape; the port's levels carry it",
    "n_levels": "the pyramid depth; the port's padded pyramid carries it",
    "n_ransac": "the draw's size; the port draws outside the graph",
}
# and per port function
NO_PARAMETER_IN = {
    ("ops/sparse_align.py", "sparse_img_align_raw"): {
        "robust": "relocalization's split on raw levels aligns without "
                  "robust weights, as the JAX relocalization calls it"},
}


def _is_jax_jit(node) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "jit" \
        and isinstance(node.value, ast.Name) and node.value.id == "jax"


def _static_names(call) -> set:
    for kw in getattr(call, "keywords", []):
        if kw.arg == "static_argnames":
            v = ast.literal_eval(kw.value)
            return {v} if isinstance(v, str) else set(v)
    return set()


def _jit_of(node):
    """(static names) when ``node`` is ``jax.jit`` or
    ``functools.partial(jax.jit, ...)``, else None."""
    if _is_jax_jit(node):
        return set()
    if isinstance(node, ast.Call) and node.args \
            and _is_jax_jit(node.args[0]) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) == "partial":
        return _static_names(node)
    return None


def _jax_jit_sites():
    """[(file, jitted name, static names, line)] of every jax.jit
    application in rpg_svo_tpu/: decorators, ``x = jax.jit(f)``,
    ``partial(jax.jit, ...)(f)`` and jits of closures (named after the
    function they sit in)."""
    sites = []
    for path in sorted((ROOT / "rpg_svo_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "rpg_svo_tpu").as_posix()
        tree = ast.parse(path.read_text())

        def visit(node, scope):
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                for d in getattr(node, "decorator_list", []):
                    st = _jit_of(d)
                    if st is not None:
                        sites.append((rel, node.name, st, node.lineno))
                scope = scope + (node.name,)
            if isinstance(node, ast.Call):
                st = _jit_of(node.func)
                if st is None and _is_jax_jit(node.func):
                    st = _static_names(node)
                if st is not None and node.args:
                    st = st | _static_names(node)
                    arg = node.args[0]
                    name = arg.id if isinstance(arg, ast.Name) \
                        else f"<jit in {'.'.join(scope)}>"
                    sites.append((rel, name, st, node.lineno))
            for child in ast.iter_child_nodes(node):
                visit(child, scope)
        visit(tree, ())
    return sites


def test_every_jax_jit_has_a_graphed_counterpart():
    """Each function rpg_svo_tpu/ passes to jax.jit has a port
    counterpart wrapped by graphed.jit with the same static names (those
    the port's signature has; the others are in NO_PARAMETER), but for
    NOT_WRAPPED."""
    sites = _jax_jit_sites()
    assert len(sites) >= 30, sites
    seen, bad = set(), []
    for rel, name, static, line in sites:
        if (rel, name) in NOT_WRAPPED:
            seen.add((rel, name))
            continue
        for prel, pname in COUNTERPARTS.get((rel, name), [(rel, name)]):
            mod = importlib.import_module(
                "rpg_svo_tpu_torch." + prel[:-3].replace("/", "."))
            f = getattr(mod, pname, None)
            where = f"rpg_svo_tpu/{rel}:{line} -> {prel}::{pname}"
            if not isinstance(f, graphed.Jitted):
                bad.append(f"{where}: not wrapped by graphed.jit")
                continue
            params = set(f.signature.parameters)
            want = CLOSURE_STATIC.get((prel, pname), static & params)
            missing = static - params - set(NO_PARAMETER) \
                - set(NO_PARAMETER_IN.get((prel, pname), ())) \
                if (prel, pname) not in CLOSURE_STATIC else set()
            if set(f.static_argnames) != want or missing:
                bad.append(f"{where}: static {sorted(f.static_argnames)}, "
                           f"JAX {sorted(static)}")
    assert not bad, bad
    assert seen == set(NOT_WRAPPED), set(NOT_WRAPPED) - seen


def test_no_module_of_the_port_disables_the_graphs():
    """graphed.disable() is for the eager references of the card checks:
    no module of the port but graphed.py names it."""
    users = []
    for path in sorted((ROOT / "rpg_svo_tpu_torch").rglob("*.py")):
        if path.name == "graphed.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and node.attr == "disable" \
                    or isinstance(node, ast.alias) and node.name == "disable":
                users.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not users, users


# --- the CPU path: the body, no graph ---------------------------------------
def _pose_case(seed=0, n=40):
    rng = np.random.default_rng(seed)
    p_w = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)) \
        + torch.tensor([0.0, 0.0, 3.0])
    f = p_w / torch.linalg.vector_norm(p_w, dim=-1, keepdim=True)
    f = f + torch.from_numpy(rng.normal(0, 1e-3, (n, 3)).astype(np.float32))
    level = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1)
    T = SE3.exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32)))
    return (T, p_w, f, level, valid, 315.5), dict(reproj_thresh=2.0,
                                                   n_iter=10)


def _points_case(seed=0, k=16, m=4):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.uniform(-1, 1, (k, 3)).astype(np.float32)) \
        + torch.tensor([0.0, 0.0, 4.0])
    R = torch.eye(3).expand(k, m, 3, 3).clone()
    t = torch.from_numpy(rng.normal(0, 0.3, (k, m, 3)).astype(np.float32))
    pc = p[:, None] + t
    f = pc / torch.linalg.vector_norm(pc, dim=-1, keepdim=True)
    p0 = p + torch.from_numpy(rng.normal(0, 0.02, (k, 3)).astype(np.float32))
    mask = torch.ones((k, m), dtype=torch.bool)
    return (p0, R, t, f, mask, torch.ones(k, dtype=torch.bool)), \
        dict(n_iter=5)


def _homography_case(seed=1, n=64):
    rng = np.random.default_rng(seed)
    H = np.array([[1.0, 0.01, 0.05], [-0.02, 1.0, -0.03],
                  [0.02, 0.01, 1.0]], np.float32)
    uv1 = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    p = np.concatenate([uv1, np.ones((n, 1), np.float32)], -1) @ H.T
    uv2 = (p[:, :2] / p[:, 2:3]).astype(np.float32)
    uv2[:10] += rng.normal(0, 0.2, (10, 2)).astype(np.float32)
    valid = torch.ones(n, dtype=torch.bool)
    idx = thom.ransac_draw(valid, 64, torch.Generator().manual_seed(3))
    return (torch.from_numpy(uv1), torch.from_numpy(uv2), valid, idx,
            0.005), {}


CASES = {"optimize_pose": (pose_opt.optimize_pose, _pose_case),
         "optimize_points": (point_opt.optimize_points, _points_case),
         "estimate_homography": (thom.estimate_homography,
                                 _homography_case)}


def _equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_call_is_the_body_and_builds_no_graph(name):
    fn, case = CASES[name]
    args, kw = case()
    graphed.reset_jit_counts()
    _equal(fn(*args, **kw), fn.fn(*args, **kw))
    st = fn.stats()
    assert st["captures"] == st["replays"] == st["graphs"] == 0


def test_vmap_runs_the_body(monkeypatch):
    """Under torch.func.vmap a wrapped function runs its body even where
    a call would replay a graph (here: every unbatched call), and equals
    the body per item."""
    assert not graphed._jit_on_card([torch.zeros(2)])
    args, kw = _points_case()
    monkeypatch.setattr(graphed, "_jit_on_card",
                        lambda ts: bool(ts) and not graphed.is_batched(*ts))
    monkeypatch.setattr(graphed, "_capture_graph", _no_capture)
    f = point_opt.optimize_points
    graphed.reset_jit_counts()
    stacked = [torch.stack([a, a]) for a in args]
    got = torch.func.vmap(lambda *a: f(*a, **kw))(*stacked)
    want = f.fn(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w) and torch.equal(g[1], w)
    assert f.captures == 0


def _no_capture(*a, **k):
    raise AssertionError("no graph may be captured here")


def test_key_follows_static_arguments_shapes_and_dtypes_not_values():
    f = pose_opt.optimize_pose
    args, kw = _pose_case()
    k0 = f.key(*args, **kw)
    assert f.key(*_pose_case(seed=5)[0], **kw) == k0          # new values
    assert f.key(*args, reproj_thresh=2.0, n_iter=10) == k0   # same call
    assert f.key(*args, n_iter=11) != k0                      # static
    assert f.key(*args, reproj_thresh=2.5, n_iter=10) != k0   # host float
    T, p_w, fm, level, valid, fx = args
    assert f.key(T, p_w[:-1], fm[:-1], level[:-1], valid[:-1], fx,
                 **kw) != k0                                  # shape
    assert f.key(T, p_w, fm, level.to(torch.int64), valid, fx,
                 **kw) != k0                                  # dtype
    with pytest.raises(TypeError):
        f.key(T, p_w, fm, level, valid, np.zeros(3), **kw)   # not a value
    with pytest.raises(ValueError):
        graphed.jit(lambda x: x, static_argnames=("y",))


# --- the replay machinery on a stand-in graph --------------------------------
def _stand_in_capture(fn, args, kwargs, dev):
    """A graph stand-in on the CPU: the capture runs the body on the input
    buffers (recording the kernel launches it reports); a replay reruns it
    there and writes the outputs' storage, as a CUDA graph rewrites its
    static outputs."""
    launches = {}
    with graphed._tracing(), graphed._recording(launches):
        out = fn(*args, **kwargs)
    leaves = pytree.tree_leaves(out)

    class Replay:
        def replay(self):
            with graphed._tracing():
                new = pytree.tree_leaves(fn(*args, **kwargs))
            for o, n in zip(leaves, new):
                if isinstance(o, torch.Tensor) and o is not n:
                    o.copy_(n)
    return graphed._Capture(out, Replay(), out, launches, 0.0, 0.0)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphed, "_jit_on_card",
                        lambda ts: bool(ts) and not graphed.is_batched(*ts))
    monkeypatch.setattr(graphed, "_capture_graph", _stand_in_capture)


@graphed.jit(static_argnames=("k",))
def _toy(x, pools, k=2, inplace=False):
    """A stage: one pool changed, the other passed through."""
    return x * k, pools._replace(a=pools.a + x.sum())


_Pools = collections.namedtuple("_Pools", "a b")


def test_replay_copies_in_and_out_and_passes_untouched_pools(stand_in):
    _toy.clear()
    graphed.reset_jit_counts()
    x, pools = torch.arange(4.0), _Pools(torch.zeros(3), torch.ones(5))
    keep = (x.clone(), pools.a.clone(), pools.b.clone())
    y, p = _toy(x, pools)
    assert torch.equal(y, x * 2) and torch.equal(p.a, torch.full((3,), 6.0))
    assert p.b is pools.b                       # passed through, not copied
    assert all(torch.equal(u, v) for u, v in zip(keep, (x, pools.a,
                                                        pools.b)))
    y.fill_(-1.0)                               # the caller owns its copy
    x2 = torch.arange(4.0) + 1.0
    y2, p2 = _toy(x2, _Pools(p.a, pools.b))     # new values: no capture
    assert torch.equal(y2, x2 * 2)
    assert torch.equal(p2.a, torch.full((3,), 16.0))
    assert _toy.captures == 1 and _toy.replays == 2
    _toy(x, pools, k=3)                         # a static argument: capture
    assert _toy.captures == 2
    with pytest.raises(ValueError):
        _toy(x, pools, inplace=True)


@graphed.jit
def _writes_its_input(x):
    return x.add_(1.0)


@graphed.jit
def _launches_a_kernel(x):
    graphed.record_launch("kernel")
    return x + 1.0


def test_capture_refuses_a_body_that_writes_its_input(stand_in):
    """A body that writes a tensor argument in place cannot be replayed
    as a functional graph (the replay would write its input buffer, not
    the caller's tensor): the capture raises and keeps no graph."""
    _writes_its_input.clear()
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="in place"):
        _writes_its_input(x)
    assert _writes_its_input.stats()["graphs"] == 0
    assert torch.equal(_writes_its_input.fn(torch.zeros(3)),
                       torch.ones(3))


def test_replays_count_the_launches_recorded_in_their_capture(stand_in):
    """A launch recorded while a graph is captured is counted at each
    replay of that graph, and only there; reset_jit_counts zeroes it;
    outside a capture record_launch counts nothing."""
    _launches_a_kernel.clear()
    graphed.reset_jit_counts()
    graphed.record_launch("kernel")
    assert graphed.replayed_launches() == {}
    _launches_a_kernel(torch.zeros(2))          # capture, then a replay
    assert graphed.replayed_launches() == {"kernel": 1}
    _launches_a_kernel(torch.ones(2))
    _launches_a_kernel(torch.ones(2))
    assert graphed.replayed_launches() == {"kernel": 3}
    graphed.reset_jit_counts()
    assert graphed.replayed_launches() == {}
    _launches_a_kernel.clear()


def test_least_recently_used_graph_goes_first(stand_in):
    _toy.clear()
    graphed.reset_jit_counts()
    pools = _Pools(torch.zeros(3), torch.ones(5))
    for n in range(graphed.JIT_MAX + 1):
        _toy(torch.ones(n + 1), pools)
    st = _toy.stats()
    assert st["graphs"] == graphed.JIT_MAX and st["evictions"] == 1
    _toy(torch.ones(1), pools)                  # the evicted one: recapture
    assert _toy.captures == graphed.JIT_MAX + 2
    _toy.clear()


def test_stand_in_handler_equals_the_eager_handler(stand_in):
    """FrameHandler over 6 frames with every stage replayed by the
    stand-in: the same poses and results as under graphed.disable(),
    one capture per stage, then replays only."""
    ds = SyntheticDataset(**FULL_SCENE, device="cpu")
    imgs = [ds.frame(i)[0] for i in range(7)]
    img0, depth0, T0 = ds.frame(0)
    cfg = tconfig.fast_preset(**dict(FULL_KW, max_n_kfs=6, max_kfs_pool=8))
    runs = []
    for graphs in (True, False):
        graphed.clear()
        graphed.reset_jit_counts()
        fh = FrameHandler(ds.cam, cfg, img_shape=SHAPE, device="cpu")
        with (contextlib.nullcontext() if graphs else graphed.disable()):
            fh.set_first_frame_with_depth(img0, T0.inverse(), depth0)
            infos = [fh.add_image(imgs[i], i / 50.0) for i in range(1, 7)]
        runs.append((infos, fh.last_frame.T_f_w.t.clone(),
                     {k: v["captures"] for k, v in
                      graphed.jit_stats().items() if v["replays"]}))
    (gi, gt, caps), (ei, et, ecaps) = runs
    assert [i["result"] for i in gi] == [i["result"] for i in ei]
    assert any(i.get("is_keyframe") for i in gi)
    assert torch.equal(gt, et)
    assert not ecaps
    assert caps and all(c == 1 for c in caps.values()), caps
    for k in ("sparse_img_align", "match_cells", "optimize_pose",
              "update_seeds", "init_seeds", "_structure_opt", "_kf_policy"):
        assert any(name.endswith("." + k) for name in caps), (k, caps)
    graphed.clear()


# --- what a capture refuses --------------------------------------------------
REFUSED = ("lift_fresh", "nonzero", "masked_select", "unique", "argwhere")


@pytest.fixture(scope="module")
def stage_log():
    """Over a handler run from the bootstrap (KLT, homography) into
    tracking with a keyframe, and over relocalization, each call of a
    wrapped function from host code, run as its body: the ops it
    dispatches that a CUDA graph's capture refuses, the keys it was called
    with, and the tensor arguments its body wrote in place."""
    from torch.utils._python_dispatch import TorchDispatchMode

    log = {"refused": collections.Counter(),
           "keys": collections.defaultdict(set),
           "written": collections.Counter()}

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if any(r in name for r in REFUSED):
                log["refused"][name] += 1
            return func(*args, **(kwargs or {}))

    def call(self, *args, **kwargs):
        if graphed._flag("disabled") or graphed._flag("tracing"):
            return self.fn(*args, **kwargs)
        log["keys"][self.__qualname__].add(self.key(*args, **kwargs))
        tensors = self._split(args, kwargs)[2]
        versions = [t._version for t in tensors]
        with graphed._tracing(), Log():
            out = self.fn(*args, **kwargs)
        if any(t._version != v for t, v in zip(tensors, versions)):
            log["written"][self.__qualname__] += 1
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphed.Jitted, "__call__", call)
        ds = SyntheticDataset(**FULL_SCENE, device="cpu")
        cfg = tconfig.fast_preset(**dict(FULL_KW, init_min_disparity=25.0))
        fh = FrameHandler(ds.cam, cfg, img_shape=SHAPE, device="cpu")
        for i in range(0, 12, 2):
            info = fh.add_image(ds.frame(i)[0], i / 50.0)
        assert fh.stage == "default" and info["result"] != "failure"
        fh.add_image(torch.zeros(SHAPE), 0.3)
        assert fh.stage == "relocalizing"
        fh.add_image(ds.frame(12)[0], 0.3)
    return log


def test_no_stage_body_builds_a_tensor_from_host_data(stage_log):
    """No wrapped body dispatches an op that a CUDA graph's capture
    refuses (a tensor made from host data, a data-dependent shape), and
    each stage sees one signature.  (Reads of a flag to end a loop early
    happen only on the CPU; the card checks its syncs under sync-debug
    "error".)"""
    assert not stage_log["refused"], stage_log["refused"]
    for k in ("track_klt", "estimate_homography", "sparse_img_align",
              "sparse_img_align_raw", "match_cells", "init_seeds",
              "update_seeds", "detect_features", "render_frame"):
        assert len(stage_log["keys"][k]) == 1, (k, len(stage_log["keys"][k]))


def test_no_stage_body_writes_its_inputs(stage_log):
    """No wrapped body called from host code writes one of its tensor
    arguments in place (its version counter), so an output that is an
    input buffer at capture is the caller's own tensor unchanged."""
    assert len(stage_log["keys"]) >= 9, sorted(stage_log["keys"])
    assert not stage_log["written"], stage_log["written"]


# --- the homography's Jacobi solves -----------------------------------------
def test_jacobi_eigenvector_and_svd_match_float64_lapack():
    """The null vectors of batched 9x9 normal matrices to float32 noise of
    float64 eigh, and the 3x3 SVD: the factors reconstruct H, S matches,
    U and V orthonormal."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn(64, 8, 9, generator=g)
    M = A.transpose(-1, -2) @ A
    w, V = thom._jacobi_eigh(M, thom.JACOBI_SWEEPS_9)
    v = V[torch.arange(64), :, torch.argmin(w, -1)].double()
    ref = torch.linalg.eigh(M.double())[1][..., 0]
    gap = torch.linalg.eigvalsh(M.double())
    good = gap[:, 1] / gap[:, -1] > 1e-3
    err = torch.minimum((v - ref).abs().amax(-1), (v + ref).abs().amax(-1))
    assert good.sum() > 40 and float(err[good].max()) < 1e-4
    for _ in range(8):
        H = torch.randn(3, 3, generator=g)
        U, S, Vt = thom._svd3(H)
        assert torch.allclose(U @ torch.diag(S) @ Vt, H, atol=1e-5)
        assert torch.allclose(S, torch.linalg.svdvals(H.double()).float(),
                              atol=1e-5)
        assert bool(torch.all(S[:-1] >= S[1:]))
        for Q in (U, Vt):
            assert torch.allclose(Q @ Q.T, torch.eye(3), atol=1e-5)
        assert abs(float(thom._det3(H)) - float(torch.linalg.det(H))) < 1e-4
