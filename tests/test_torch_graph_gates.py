"""The fused step's mapping stages as gates (``core/graphed.gate``).

The step runs in three phases (``core/fused._track``, ``_mapping``,
``_finish``), and each mapping stage, the depth-filter update and the
keyframe stages, is a gate on its device predicate: the masked stage
outside a graph, an IF node inside the step's graph on the card.

On the CPU: a gate outside a capture is its masked body, for either value
of its predicate; the phase-split step equals the masked step of before
the split (``svo_bench/reference``'s frozen copy of the port's eager step
body) bit for bit over the whole-step scene, one stream and a batch of
two; with ``cfg.shard_axis`` set the stages stay masked, with no gate; the
gate counters count and reset.

On the card (marker ``cuda``; the file imports nothing of JAX, so it runs
there with ``--noconftest``): the gated graphs of ``vo_step_donated``,
``vo_scan`` and ``vmapped_vo_step`` (B = 2 and 8, streams taking their
keyframes at different steps) against the eager masked step over the
whole-step scene's frames, which hold frames where the depth filter is
due and where it is not, keyframes that delete a keyframe at the map cap
and a relocalizing frame: every state leaf and output bit-equal, no host
sync in a replay, and the gate counters equal to the eager run's (its
keyframes and due frames).
"""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch.core import fused, graphed
from rpg_svo_tpu_torch.core import map as svomap
from rpg_svo_tpu_torch.ops.detector import grid_dims
from rpg_svo_tpu_torch.parallel import streams
from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset

from _torch_port import FULL_KW, FULL_SCENE, SHAPE, need_cuda

N_FRAMES = 16          # the whole-step scene: keyframes every 3-4 frames
RELOC_AT = 9           # this frame starts from the relocalizing stage
STREAM_EVERY = 2       # stream b of a batch starts after frame b * this
STREAM_STEPS = 6


def _leaves_equal(a, b, what):
    for i, (x, y) in enumerate(zip(pytree.tree_leaves(a),
                                   pytree.tree_leaves(b))):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy(),
                                      err_msg=f"{what}: leaf {i}")


def _relocalizing(state):
    return state._replace(stage=torch.full_like(state.stage,
                                                fused.STAGE_RELOC))


def _seed(mod, ds, cam, cfg, se3, dev):
    img0, depth0, T0 = ds.frame(0)
    Tfw = T0.inverse()
    return mod.seed_first_frame_with_depth(
        img0, se3(Tfw.R, Tfw.t), depth0, cam, cfg, img_shape=SHAPE,
        device=dev)


# --- the CPU ---------------------------------------------------------------
@pytest.fixture(scope="module")
def cpu_scene():
    ds = SyntheticDataset(device="cpu", **FULL_SCENE)
    imgs = [ds.frame(i)[0] for i in range(N_FRAMES + 1)]
    return ds, imgs


def _reference(preset):
    """The masked step of before the split: svo_bench's frozen copy of the
    port's step body, its config and camera."""
    from svo_bench.reference.svo import config as rconfig
    from svo_bench.reference.svo.core import fused as rfused
    from svo_bench.reference.svo.geometry.cameras import PinholeCamera
    from svo_bench.reference.svo.geometry.se3 import SE3 as RSE3
    cfg = getattr(rconfig, f"{preset}_preset")(**FULL_KW)
    cam = PinholeCamera.make(SHAPE[1], SHAPE[0], 315.5, 315.5,
                             SHAPE[1] / 2.0, SHAPE[0] / 2.0)
    return rfused, cfg, cam, RSE3


def _run(mod, state, imgs, cam, cfg, ncx, ncy):
    """States (index i: after frame i) and outputs of the eager masked
    step over frames 1..N_FRAMES, frame RELOC_AT relocalizing."""
    states, outs = [state], []
    for i in range(1, N_FRAMES + 1):
        if i == RELOC_AT:
            state = _relocalizing(state)
        state, o = mod._vo_step(state, imgs[i], cam, cfg, ncx, ncy, SHAPE,
                                inplace=False)
        states.append(state)
        outs.append(o)
    return states, outs


@pytest.fixture(scope="module")
def cpu_runs(cpu_scene):
    """Per preset: the phase-split step and the masked reference over the
    scene, each from its own seeding."""
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    ds, imgs = cpu_scene
    out = {}
    for preset in ("fast", "accurate"):
        cfg = getattr(tconfig, f"{preset}_preset")(**FULL_KW)
        ncx, ncy = grid_dims(SHAPE[1], SHAPE[0], cfg.grid_size)
        rfused, rcfg, rcam, RSE3 = _reference(preset)
        got = _run(fused, _seed(fused, ds, ds.cam, cfg, SE3, "cpu"), imgs,
                   ds.cam, cfg, ncx, ncy)
        ref = _run(rfused, _seed(rfused, ds, rcam, rcfg, RSE3, "cpu"), imgs,
                   rcam, rcfg, ncx, ncy)
        out[preset] = dict(cfg=cfg, rcfg=rcfg, rcam=rcam, rfused=rfused,
                           grid=(ncx, ncy), got=got, ref=ref)
    return out


@pytest.mark.parametrize("held", [False, True])
def test_gate_outside_a_capture_is_its_masked_body(held):
    """Off the card a gate calls its body once and returns what the body
    returns, its inputs left as they were, whichever way its predicate
    reads."""
    pred = torch.tensor(held)
    x, y = torch.arange(4.0), torch.ones(3, dtype=torch.int32)
    before = (x.clone(), y.clone())
    calls = []

    def body(leaves):
        a, b = leaves
        new = (torch.where(pred, a * 2 + 1, a), torch.where(pred, b + 5, b))
        calls.append(new)
        return new
    got = graphed.gate("test.masked", pred, body, (x, y))
    assert len(calls) == 1 and got is calls[0]
    assert torch.equal(got[0], before[0] * 2 + 1 if held else before[0])
    assert torch.equal(got[1], before[1] + 5 if held else before[1])
    assert torch.equal(x, before[0]) and torch.equal(y, before[1])


def test_gate_counters_count_and_reset():
    """``gate_stats`` counts every gate passed and those whose predicate
    held, by name, until ``reset_jit_counts``; nothing under vmap."""
    graphed.reset_jit_counts()
    for held in (True, False, True, False, False):
        graphed.gate("test.count", torch.tensor(held), lambda v: v,
                     torch.zeros(2))
    graphed.gate("test.other", torch.tensor(True), lambda v: v,
                 torch.zeros(2))
    torch.func.vmap(lambda p: graphed.gate("test.count", p, lambda v: v,
                                           p))(torch.ones(3, dtype=bool))
    stats = graphed.gate_stats()
    assert stats["test.count"] == {"reached": 5, "ran": 2}
    assert stats["test.other"] == {"reached": 1, "ran": 1}
    graphed.reset_jit_counts()
    assert graphed.gate_stats()["test.count"] == {"reached": 0, "ran": 0}


def test_write_back_keeps_the_storage_and_refuses_aliases():
    """A gate's body ends in ``write_back``: new leaves go into the old
    leaves' storage; a leaf returned in another leaf's storage, or with
    another shape, raises."""
    a, b = torch.zeros(3), torch.ones(3)
    ptrs = (a.data_ptr(), b.data_ptr())
    graphed.write_back((a, b), (a + 2, b))
    assert (a.data_ptr(), b.data_ptr()) == ptrs
    assert a.tolist() == [2.0] * 3 and b.tolist() == [1.0] * 3
    with pytest.raises(ValueError):
        graphed.write_back((a, b), (b, b))
    with pytest.raises(ValueError):
        graphed.write_back((a, b), (torch.zeros(4), b))


@pytest.mark.parametrize("preset", ["fast", "accurate"])
def test_phase_split_step_equals_the_masked_step(cpu_runs, preset):
    """The phase-split step body over 16 frames of the whole-step scene
    equals the masked step of before the split bit for bit, every state
    leaf and output; the frames hold keyframes, a keyframe deleted at the
    map cap, due and skipped depth-filter updates and a relocalizing
    frame."""
    r = cpu_runs[preset]
    (gs, go), (rs, ro) = r["got"], r["ref"]
    for i, (a, b) in enumerate(zip(gs, rs)):
        _leaves_equal(a, b, f"state after frame {i}")
    for i, (a, b) in enumerate(zip(go, ro), 1):
        _leaves_equal(a, b, f"outputs of frame {i}")
    kfs = [i for i, o in enumerate(go, 1) if bool(o.is_keyframe)]
    capped = [i for i in kfs
              if int(svomap.n_active_kfs(gs[i - 1].m)) >= r["cfg"].max_n_kfs]
    assert len(kfs) >= 3 and capped, (kfs, capped)
    assert any(i % 2 and i not in kfs for i in range(1, N_FRAMES + 1))
    assert int(gs[RELOC_AT - 1].stage) == fused.STAGE_DEFAULT
    assert not bool(go[RELOC_AT - 1].failed)


def _stream_batch(states, B):
    return streams.stack_states([states[b * STREAM_EVERY] for b in range(B)])


def _stream_imgs(imgs, B, j):
    return torch.stack([imgs[b * STREAM_EVERY + j] for b in range(B)])


def test_phase_split_batch_equals_the_masked_batch(cpu_scene, cpu_runs):
    """The batched step (tracking and finish under vmap, each mapping
    stage a gate around a vmapped body) equals the masked step of before
    the split under vmap, bit for bit, over 6 steps of 2 streams that take
    their keyframes on different steps."""
    _, imgs = cpu_scene
    r = cpu_runs["fast"]
    ncx, ncy = r["grid"]
    rf = r["rfused"]
    sg = _stream_batch(r["got"][0], 2)
    sr = _stream_batch(r["ref"][0], 2)
    kfs = []
    for j in range(1, STREAM_STEPS + 1):
        x = _stream_imgs(imgs, 2, j)
        sg, og = streams._vmapped_step(sg, x, _cam(cpu_scene), r["cfg"],
                                       ncx, ncy, SHAPE)
        sr, orf = torch.func.vmap(
            lambda s, im: rf._vo_step(s, im, r["rcam"], r["rcfg"], ncx, ncy,
                                      SHAPE, inplace=False))(sr, x)
        _leaves_equal(sg, sr, f"batched state after step {j}")
        _leaves_equal(og, orf, f"batched outputs of step {j}")
        kfs.append(og.is_keyframe.tolist())
    assert any(k[0] != k[1] for k in kfs), kfs


def _cam(cpu_scene):
    return cpu_scene[0].cam


@pytest.mark.parametrize("batched", [False, True])
def test_sharded_step_keeps_the_masked_stages(cpu_scene, cpu_runs,
                                              monkeypatch, batched):
    """With ``cfg.shard_axis`` set (the mesh programs, whose stages hold
    collectives) both mapping stages pass their gates with no IF node;
    without it both branch, but for the keyframe stages where they hold
    local BA (whose solve a conditional body cannot hold)."""
    _, imgs = cpu_scene
    r = cpu_runs["fast"]
    cfg, (ncx, ncy) = r["cfg"], r["grid"]
    gates, bodies = [], []

    def gate(name, pred, body, leaves, branch=True):
        gates.append((name, branch))
        return body(leaves)
    monkeypatch.setattr(graphed, "gate", gate)
    monkeypatch.setattr(fused, "_depth_filter",
                        lambda m, t, **kw: bodies.append("df") or m)
    monkeypatch.setattr(fused, "_keyframe_stages",
                        lambda m, t, **kw: bodies.append("kf") or m)

    def track(s, img):
        return fused._track(s, img, _cam(cpu_scene), cfg, ncx, ncy, SHAPE,
                            inplace=False)
    if batched:
        t = torch.func.vmap(track)(_stream_batch(r["got"][0], 2),
                                   _stream_imgs(imgs, 2, 1))
    else:
        t = track(r["got"][0][0], imgs[1])
    for kw, want in ((dict(shard_axis="sp"), (False, False)),
                     (dict(shard_axis=""), (True, True)),
                     (dict(loba_num_iter=10), (True, False))):
        gates.clear()
        bodies.clear()
        fused._mapping(t, _cam(cpu_scene), cfg.replace(**kw), ncx, ncy,
                       inplace=False, batched=batched)
        assert gates == [("depth_filter", want[0]), ("keyframe", want[1])]
        assert bodies == ["df", "kf"], kw


# --- the card --------------------------------------------------------------
def _eager(state, img, cam, cfg, ncx, ncy):
    with graphed.disable():
        return fused._vo_step(state, img, cam, cfg, ncx, ncy, SHAPE,
                              inplace=False)


def _clone(state):
    return pytree.tree_map(torch.clone, state)


@pytest.fixture(scope="module")
def card_runs():
    """The eager masked step over the scene on the card (its states, its
    outputs and the gate counters it left), fast preset."""
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    dev = need_cuda()
    graphed.clear()
    ds = SyntheticDataset(device=dev, **FULL_SCENE)
    last = STREAM_EVERY * 7 + STREAM_STEPS
    imgs = [ds.frame(i)[0] for i in range(max(N_FRAMES, last) + 1)]
    cfg = tconfig.fast_preset(**FULL_KW)
    ncx, ncy = grid_dims(SHAPE[1], SHAPE[0], cfg.grid_size)
    seeded = _seed(fused, ds, ds.cam, cfg, SE3, dev)
    graphed.reset_jit_counts()
    states, outs = [_clone(seeded)], []
    st = seeded
    for i in range(1, N_FRAMES + 1):
        if i == RELOC_AT:
            st = _relocalizing(st)
        st, o = _eager(st, imgs[i], ds.cam, cfg, ncx, ncy)
        states.append(st)
        outs.append(o)
    stats = graphed.gate_stats()
    return dict(ds=ds, imgs=imgs, cfg=cfg, grid=(ncx, ncy), states=states,
                outs=outs, stats=stats)


def _syncs_refused():
    torch.cuda.set_sync_debug_mode("error")


@pytest.mark.cuda
def test_gated_donated_step_equals_the_eager_masked_step(card_runs):
    """vo_step_donated (a capture on the first frame, replays after) over
    the scene against the eager masked step: every leaf of the state and
    every output bit-equal at every frame, no host sync in a replay, the
    gate counters equal to the eager run's; the frames hold skipped and
    due depth-filter updates, keyframes (one at the map cap) and a
    relocalizing frame."""
    r = card_runs
    ncx, ncy = r["grid"]
    kfs = [i for i, o in enumerate(r["outs"], 1) if bool(o.is_keyframe)]
    assert len(kfs) >= 3 and any(
        int(svomap.n_active_kfs(r["states"][i - 1].m)) >= r["cfg"].max_n_kfs
        for i in kfs), kfs
    st = _clone(r["states"][0])
    graphed.reset_jit_counts()
    for i in range(1, N_FRAMES + 1):
        if i == RELOC_AT:
            st.stage.fill_(fused.STAGE_RELOC)
        if i > 1:
            _syncs_refused()
        try:
            st, o = fused.vo_step_donated(st, r["imgs"][i], r["ds"].cam,
                                          r["cfg"], ncx, ncy, SHAPE)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _leaves_equal(st, r["states"][i], f"state after frame {i}")
        _leaves_equal(o, r["outs"][i - 1], f"outputs of frame {i}")
    stats = graphed.gate_stats()
    assert stats == r["stats"], (stats, r["stats"])
    assert stats["keyframe"]["ran"] == len(kfs)
    assert 0 < stats["depth_filter"]["ran"] < N_FRAMES


@pytest.mark.cuda
def test_gated_scan_equals_the_eager_masked_step(card_runs):
    """vo_scan (the slot's graph) over the frames before the relocalizing
    one and then from it to the end: the same states and outputs as the
    eager masked step, bit for bit, and the same gate counts."""
    r = card_runs
    ncx, ncy = r["grid"]
    graphed.reset_jit_counts()
    st, o1 = fused.vo_scan(r["states"][0], torch.stack(
        r["imgs"][1:RELOC_AT]), r["ds"].cam, r["cfg"], ncx, ncy, SHAPE)
    _leaves_equal(st, r["states"][RELOC_AT - 1], "state before relocalizing")
    st, o2 = fused.vo_scan(_relocalizing(st), torch.stack(
        r["imgs"][RELOC_AT:N_FRAMES + 1]), r["ds"].cam, r["cfg"], ncx, ncy,
        SHAPE)
    _leaves_equal(st, r["states"][N_FRAMES], "final state")
    _leaves_equal(fused.StepOut(*(torch.cat(x) for x in zip(o1, o2))),
                  fused.stack_outs(r["outs"]), "stacked outputs")
    assert graphed.gate_stats() == r["stats"]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 8])
def test_gated_batch_equals_the_eager_masked_batch(card_runs, B):
    """vmapped_vo_step at B streams starting STREAM_EVERY frames apart
    (keyframes on different steps) against the eager masked batch: every
    stacked leaf and output bit-equal after each step, no host sync in a
    replay, and the gate counters equal to the eager batch's (a gate
    passed once per step, run where any stream needs it)."""
    r = card_runs
    ncx, ncy = r["grid"]
    cam, cfg = r["ds"].cam, r["cfg"]
    starts = [b * STREAM_EVERY for b in range(B)]
    steps = [torch.stack([r["imgs"][s + j] for s in starts])
             for j in range(1, STREAM_STEPS + 1)]
    graphed.reset_jit_counts()
    se, eager = streams.stack_states([r["states"][s] for s in starts]), []
    with graphed.disable():
        for x in steps:
            se, oe = streams._vmapped_step(se, x, cam, cfg, ncx, ncy, SHAPE)
            eager.append((se, oe))
    eager_stats = graphed.gate_stats()
    graphed.reset_jit_counts()
    sg = streams.stack_states([r["states"][s] for s in starts])
    for j, (x, (se, oe)) in enumerate(zip(steps, eager), 1):
        if j > 1:
            _syncs_refused()
        try:
            sg, og = streams.vmapped_vo_step(sg, x, cam, cfg, ncx, ncy,
                                             SHAPE)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _leaves_equal(sg, se, f"B={B}: states after step {j}")
        _leaves_equal(og, oe, f"B={B}: outputs of step {j}")
    kfs = [oe.is_keyframe.tolist() for _, oe in eager]
    assert any(0 < sum(k) < B for k in kfs), kfs
    assert graphed.gate_stats() == eager_stats
    assert eager_stats["keyframe"] == {"reached": STREAM_STEPS,
                                       "ran": sum(any(k) for k in kfs)}
