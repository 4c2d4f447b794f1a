"""The port's donated step (``core/fused.vo_step_donated`` and
``vo_scan_donated``) against its functional step and against the JAX
package's ``vo_step_donated``, on the CPU.

The port's own run of the whole-step scene (tests/_torch_port.py,
``FULL_KW``), seeded by the port, over frames 1-8 (a keyframe at frame 6):
the donated step from a clone of the seeding equals ``vo_step`` bit for
bit, outputs and states, in both presets (local BA runs in the accurate
one); every leaf of its state keeps its storage from step to step, while
``vo_step`` leaves its input equal to a clone taken before the step.
Against JAX: frames 6 and 7 from the port's state after frame 5,
converted, at the whole-step tolerances of tests/test_torch_fused.py
(1e-5 m after one step, 1e-4 after two).

On the card the donated step is a CUDA graph keyed by the state's storage,
and vo_step, vo_scan and vmapped_vo_step step a graph-owned slot keyed by
the state's shapes (core/graphed.py; tests/test_torch_cuda_kernels.py runs
them there): here, the keys' parts, that a CPU call builds no graph and
no slot, and that the step dispatches no op that builds a tensor from host
data (on the card a pageable copy to the device, which a capture
refuses)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu import config as jconfig
from rpg_svo_tpu.core import fused as jfused
from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch.core import fused as tfused
from rpg_svo_tpu_torch.core import graphed
from rpg_svo_tpu_torch.core import map as tmap
from rpg_svo_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3
from rpg_svo_tpu_torch.parallel.streams import stack_states

from _torch_port import FULL_KW, SHAPE, jax_state, jax_tree, run_full, \
    to_torch
from test_torch_fused import _compare_full, _outs_equal

N_FRAMES = 8
JAX_FROM = 5           # the JAX comparison: frames 6 and 7 from here


def _clone(state):
    return pytree.tree_map(torch.clone, state)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def _ptrs(state):
    return [x.data_ptr() for x in pytree.tree_leaves(state)]


@pytest.fixture(scope="module")
def scene():
    """The whole-step scene (frame 0's image, depth and pose, the grid),
    with no JAX step run."""
    return run_full("fast", 0)


def _imgs(scene):
    return [to_torch(np.asarray(scene["ds"].frame(i)[0]))
            for i in range(1, N_FRAMES + 1)]


@pytest.fixture(scope="module")
def runs(scene):
    """Per preset: the seeding, then N_FRAMES of vo_step (each checked to
    leave its input as it was) and of vo_step_donated from a clone of the
    seeding (the data pointers of its leaves after each step)."""
    out = {}
    ncx, ncy = scene["fh"].ncx, scene["fh"].ncy
    imgs = _imgs(scene)
    for preset in ("fast", "accurate"):
        cfg = getattr(tconfig, f"{preset}_preset")(**FULL_KW)
        Tfw = scene["T0"].inverse()
        s0 = tfused.seed_first_frame_with_depth(
            to_torch(scene["img0"]), TSE3(to_torch(Tfw.R), to_torch(Tfw.t)),
            to_torch(scene["depth0"]), scene["cam"], cfg, img_shape=SHAPE,
            device="cpu")
        states, outs, kept = [s0], [], []
        for img in imgs:
            before = _clone(states[-1])
            s, o = tfused.vo_step(states[-1], img, scene["cam"], cfg, ncx,
                                  ncy, SHAPE)
            kept.append(_equal(states[-1], before))
            states.append(s)
            outs.append(o)
        d = _clone(s0)
        ptrs0 = _ptrs(d)
        d_states, d_outs, same_storage = [], [], []
        for img in imgs:
            d, o = tfused.vo_step_donated(d, img, scene["cam"], cfg, ncx,
                                          ncy, SHAPE)
            d_states.append(_clone(d))
            d_outs.append(o)
            same_storage.append(_ptrs(d) == ptrs0)
        out[preset] = dict(cfg=cfg, states=states, outs=outs, kept=kept,
                           d_states=d_states, d_outs=d_outs,
                           same_storage=same_storage)
    return out


@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_donated_step_equals_vo_step(runs, preset):
    r = runs[preset]
    assert any(bool(o.is_keyframe) for o in r["outs"])
    assert not any(bool(o.failed) for o in r["outs"])
    for i, (o, od) in enumerate(zip(r["outs"], r["d_outs"])):
        assert _equal(o, od), i
        assert _equal(r["states"][i + 1], r["d_states"][i]), i


@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_donated_step_writes_the_pools_in_place(runs, preset):
    """Every leaf of the donated step's state, the pools and the frame's
    own leaves (pyramid, pose, feature table, counters), is its input's
    storage after every step; vo_step leaves its input as it was."""
    r = runs[preset]
    assert all(r["same_storage"]), r["same_storage"]
    assert all(r["kept"]), r["kept"]


def test_donated_scan_equals_the_step_loop(scene, runs):
    r = runs["fast"]
    st, outs = tfused.vo_scan_donated(
        _clone(r["states"][0]), _imgs(scene), scene["cam"], r["cfg"],
        scene["fh"].ncx, scene["fh"].ncy, SHAPE)
    assert _equal(outs, tfused.stack_outs(r["d_outs"]))
    assert _equal(st, r["d_states"][-1])


def test_donated_step_matches_jax(scene, runs):
    """Frames 6 (a keyframe) and 7 from the port's state after frame 5:
    the port's donated step against JAX's."""
    r = runs["fast"]
    tree = state_to_numpy(r["states"][JAX_FROM])
    jcfg = jconfig.fast_preset(**FULL_KW)
    js = jax_state(tree)
    ts = state_from_numpy(tree, device="cpu")
    kfs = []
    for k, atol in ((JAX_FROM, 1e-5), (JAX_FROM + 1, 1e-4)):
        img = np.asarray(scene["ds"].frame(k + 1)[0])
        js, jo = jfused.vo_step_donated(js, jnp.asarray(img), scene["ds"].cam,
                                        jcfg, scene["fh"].ncx,
                                        scene["fh"].ncy, SHAPE)
        ts, to = tfused.vo_step_donated(ts, to_torch(img), scene["cam"],
                                        r["cfg"], scene["fh"].ncx,
                                        scene["fh"].ncy, SHAPE)
        _outs_equal(to, jo, atol)
        kfs.append(bool(to.is_keyframe))
    assert any(kfs)
    _compare_full(state_to_numpy(ts), jax_tree(js), 1e-4)


def test_row_writes_in_place_equal_their_copies():
    """set_rows in place: the pool's own storage, the values of the
    out-of-place form.  Its invalid rows (one of them at a valid row's
    index) leave every other row, the scratch row included, bit-equal."""
    rng = np.random.default_rng(5)
    arr = to_torch(rng.normal(size=(10, 3)).astype(np.float32))
    idx = to_torch(np.array([2, 4, 4, 0, 7], np.int64))
    ok = to_torch(np.array([True, False, True, False, True]))
    vals = to_torch(rng.normal(size=(5, 3)).astype(np.float32))
    want = tmap.set_rows(arr, idx, vals, ok)
    pool = arr.clone()
    got = tmap.set_rows(pool, idx, vals, ok, inplace=True)
    assert got.data_ptr() == pool.data_ptr() and torch.equal(got, want)
    keep = np.setdiff1d(np.arange(10), [2, 4, 7])
    assert torch.equal(want[keep], arr[keep])
    assert torch.equal(want[[2, 4, 7]], vals[[0, 2, 4]])


def test_donated_step_raises_under_vmap(scene, runs):
    r = runs["fast"]
    states = stack_states([r["states"][1], r["states"][2]])
    imgs = torch.stack(_imgs(scene)[2:4])

    def step(s, img):
        return tfused.vo_step_donated(s, img, scene["cam"], r["cfg"],
                                      scene["fh"].ncx, scene["fh"].ncy, SHAPE)
    with pytest.raises(RuntimeError, match="vmap"):
        torch.func.vmap(step)(states, imgs)


def test_graph_key_follows_storage_and_static_arguments(scene, runs):
    """The graph key changes with a cloned state, another configuration,
    another camera and another image shape; a donated step keeps its
    state's key; a CPU call builds no graph."""
    r = runs["fast"]
    cam, ncx, ncy = scene["cam"], scene["fh"].ncx, scene["fh"].ncy
    img = _imgs(scene)[0]

    def key(state, img=img, cam=cam, cfg=r["cfg"], shape=SHAPE):
        return graphed.graph_key(
            tfused._static_args(cam, cfg, ncx, ncy, shape), state, img)
    graphed.clear()
    st = _clone(r["states"][0])
    k = key(st)
    assert key(_clone(st)) != k
    assert key(st, cfg=runs["accurate"]["cfg"]) != k
    assert key(st, cfg=r["cfg"].replace(ablate=("df",))) != k
    assert key(st, cam=cam._replace(fx=cam.fx + 1.0)) != k
    assert key(st, img=img[:-8]) != k
    assert key(st, img=img.to(torch.float64)) != k
    assert key(st) == k
    st2, _ = tfused.vo_step_donated(st, img, cam, r["cfg"], ncx, ncy, SHAPE)
    assert st2 is st and key(st2) == k
    assert graphed.graphs() == []


def test_slot_key_follows_shapes_not_storage(scene, runs):
    """The slot of the kept-state entries (graphed.slot_key) is the same
    for a clone of a state (another storage) and differs for another
    batch size, configuration, camera, image shape or image dtype."""
    r = runs["fast"]
    cam, ncx, ncy = scene["cam"], scene["fh"].ncx, scene["fh"].ncy
    img = _imgs(scene)[0]
    st = r["states"][1]

    def key(state, img=img, cam=cam, cfg=r["cfg"], shape=SHAPE, tag=()):
        return graphed.slot_key(
            tag + tfused._static_args(cam, cfg, ncx, ncy, shape), state, img)
    k = key(st)
    assert key(_clone(st)) == k and key(st) == k
    assert key(st, cfg=runs["accurate"]["cfg"]) != k
    assert key(st, cfg=r["cfg"].replace(ablate=("df",))) != k
    assert key(st, cam=cam._replace(fx=cam.fx + 1.0)) != k
    assert key(st, img=img[:-8]) != k
    assert key(st, img=img.to(torch.float64)) != k
    # a stream batch: one slot per B, whatever the states' storage
    two = stack_states(r["states"][1:3])
    imgs2 = torch.stack(_imgs(scene)[:2])
    kb = key(two, img=imgs2, tag=("vmapped",))
    assert key(stack_states(r["states"][3:5]), img=imgs2,
               tag=("vmapped",)) == kb
    assert key(stack_states(r["states"][1:4]),
               img=torch.stack(_imgs(scene)[:3]), tag=("vmapped",)) != kb


def test_cpu_entries_build_no_slot_or_graph(scene, runs):
    """On the CPU vo_step, vo_scan and vmapped_vo_step run eagerly: no
    slot and no graph is made, and vo_scan's outputs are stacked along
    T as vo_step's, frame by frame."""
    from rpg_svo_tpu_torch.parallel.streams import vmapped_vo_step
    r = runs["fast"]
    args = (scene["cam"], r["cfg"], scene["fh"].ncx, scene["fh"].ncy, SHAPE)
    imgs = _imgs(scene)
    graphed.clear()
    st, out = tfused.vo_step(r["states"][0], imgs[0], *args)
    assert _equal(out, r["outs"][0]) and _equal(st, r["states"][1])
    st, outs = tfused.vo_scan(r["states"][0], imgs[:2], *args)
    assert _equal(outs, tfused.stack_outs(r["outs"][:2]))
    assert _equal(st, r["states"][2])
    vmapped_vo_step(stack_states(r["states"][:2]), torch.stack(imgs[:2]),
                    *args)
    assert graphed.slots() == [] and graphed.graphs() == []


@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_donated_step_builds_no_tensor_from_host_data(scene, runs, preset):
    """A donated step (frame 2, after one step has made the device tables)
    dispatches no ``lift_fresh``: no tensor made from host data, which on
    the card is a pageable copy that a CUDA graph's capture refuses."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    r = runs[preset]
    st, img = _clone(r["states"][1]), _imgs(scene)[1]
    with Log() as log:
        tfused.vo_step_donated(st, img, scene["cam"], r["cfg"],
                               scene["fh"].ncx, scene["fh"].ncy, SHAPE)
    assert len(log.ops) > 1000
    assert not [op for op in log.ops if "lift_fresh" in op]
