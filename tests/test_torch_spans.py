"""The port's program spans (core/spans.py) and the slots' copy counter.

On the CPU, on the small whole-step scene of ``_torch_port`` (the port's
own renderer, no JAX): with spans off the handler, the donated step and
the batched step record no span and make no CUDA event or span object,
and their results are bit-equal to the same steps with spans on; with
spans on the handler's spans carry the reference's SVO_TRACE names under
one ``add_image`` root per frame and write their seconds into the
frame's info dict, and the fused step's stages come out in stage order,
under ``torch.func.vmap`` too.  The span tree (nesting, one boundary for
``switch``, unwinding on an exception, host self time, the ``svo.``
profiler ranges), the trace CSV made from info dicts completed after
they were logged, and ``graphed.slot`` / ``fresh_copy`` counting the
leaves' bytes.

On the card (marker ``cuda``; the file imports nothing of JAX, so
``python -m pytest --noconftest -q tests/test_torch_spans.py`` runs it
there): the fused graph's stage spans cover 90-100% of its replay's
event time (donated step, and the batched step at B = 2); the switch
keys a separate graph, and only the graph captured with spans on holds
event-record nodes; the handler with spans on calls no
``torch.cuda.synchronize`` in ``add_image`` and its info dicts get the
stage times from the card's events.
"""

import contextlib
import csv

import pytest
import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch.core import fused, graphed, spans
from rpg_svo_tpu_torch.core.pipeline import FrameHandler
from rpg_svo_tpu_torch.io.trace import TraceWriter
from rpg_svo_tpu_torch.ops.detector import grid_dims
from rpg_svo_tpu_torch.parallel import streams
from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset

from _torch_port import FULL_KW, FULL_SCENE, SHAPE, need_cuda

N_FRAMES = 4
HANDLER_NAMES = {"add_image", "pyramid_creation", "sparse_img_align",
                 "reproject", "reproject_kfs", "reproject_candidates",
                 "feature_align", "pose_optimizer", "point_optimizer",
                 "depth_filter", "keyframe", "local_ba"}
STEP_STAGES = ["pyramid_creation", "sparse_img_align", "reproject",
               "pose_optimizer", "quality_gates", "point_optimizer",
               "kf_policy", "depth_filter", "keyframe"]


def _clone(state):
    return pytree.tree_map(torch.clone, state)


def _equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


@contextlib.contextmanager
def _nothing_made(monkeypatch):
    """Raises if a CUDA event or a span object is made inside."""
    def refuse(*a, **k):
        raise AssertionError("made with spans off")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "Event", refuse)
        m.setattr(spans, "_Open", refuse)
        yield


@pytest.fixture(scope="module")
def scene():
    ds = SyntheticDataset(device="cpu", **FULL_SCENE)
    cfg = tconfig.fast_preset(**FULL_KW)
    img0, depth0, T0 = ds.frame(0)
    imgs = [ds.frame(i)[0] for i in range(1, N_FRAMES + 1)]
    ncx, ncy = grid_dims(SHAPE[1], SHAPE[0], cfg.grid_size)
    state0 = fused.seed_first_frame_with_depth(
        img0, T0.inverse(), depth0, ds.cam, cfg, img_shape=SHAPE,
        device="cpu")
    return dict(ds=ds, cfg=cfg, first=(img0, depth0, T0), imgs=imgs,
                grid=(ncx, ncy), state0=state0)


def _handler_run(scene, on: bool):
    img0, depth0, T0 = scene["first"]
    fh = FrameHandler(scene["ds"].cam, scene["cfg"], img_shape=SHAPE,
                      device="cpu")
    fh.set_first_frame_with_depth(img0, T0.inverse(), depth0)
    spans.clear()
    with spans.recording() if on else contextlib.nullcontext():
        infos = [fh.add_image(img, i / 50.0)
                 for i, img in enumerate(scene["imgs"], 1)]
    return fh, infos, spans.recorded()


@pytest.fixture(scope="module")
def handler_runs(scene):
    """The handler over the scene's frames with spans on."""
    return _handler_run(scene, True)


def _step(scene, entry: str):
    """(state, outputs) of one step of ``entry`` from the seeding."""
    cam, cfg, (ncx, ncy) = scene["ds"].cam, scene["cfg"], scene["grid"]
    img = scene["imgs"][0]
    if entry == "vo_step_donated":
        return fused.vo_step_donated(_clone(scene["state0"]), img, cam,
                                     cfg, ncx, ncy, SHAPE)
    two = streams.stack_states([scene["state0"], scene["state0"]])
    return streams.vmapped_vo_step(two, torch.stack([img, img]), cam, cfg,
                                   ncx, ncy, SHAPE)


@pytest.mark.parametrize("entry", ["add_image", "vo_step_donated",
                                   "vmapped_vo_step"])
def test_spans_off_record_nothing_and_change_nothing(scene, handler_runs,
                                                     monkeypatch, entry):
    """With spans off an entry makes no span object and no CUDA event and
    records nothing; its results are bit-equal to the same run with
    spans on."""
    spans.clear()
    with _nothing_made(monkeypatch):
        if entry == "add_image":
            off = _handler_run(scene, False)
        else:
            off = _step(scene, entry)
    assert spans.recorded() == []
    if entry == "add_image":
        fh_on, infos_on, _ = handler_runs
        fh_off, infos_off, _ = off
        assert _equal((fh_off.map, fh_off.last_frame),
                      (fh_on.map, fh_on.last_frame))
        for a, b in zip(infos_off, infos_on):
            assert not set(a) & HANDLER_NAMES
            assert {k: v for k, v in b.items() if k not in HANDLER_NAMES
                    and k != "proc_time"} \
                == {k: v for k, v in a.items() if k != "proc_time"}
        return
    with spans.recording():
        on = _step(scene, entry)
    assert spans.recorded() and _equal(off, on)


def test_handler_spans_carry_the_svo_trace_names(handler_runs):
    """One root ``add_image`` per frame, every other span of the frame
    under it with a SVO_TRACE name (the reprojection stages inside
    ``reproject``), and the frame's info holding each name's seconds."""
    _, infos, rec = handler_runs
    by_frame: dict = {}
    for s in rec:
        by_frame.setdefault(s.frame, []).append(s)
    assert len(by_frame) == N_FRAMES
    assert any(i.get("is_keyframe") for i in infos)
    for info, group in zip(infos, sorted(by_frame.values(),
                                         key=lambda g: g[0].id)):
        roots = [s for s in group if s.parent == -1]
        assert [s.name for s in roots] == ["add_image"]
        ids = {s.id: s for s in group}
        for s in group:
            assert s.name in HANDLER_NAMES and s.device is None
            assert s.host[0] <= s.host[1]
            if s.parent != -1:
                assert s.parent in ids
            if s.name in ("reproject_kfs", "reproject_candidates",
                          "feature_align"):
                assert ids[s.parent].name == "reproject"
        sums: dict = {}
        for s in group:
            sums[s.name] = sums.get(s.name, 0.0) \
                + (s.host[1] - s.host[0]) / 1e9
        assert {k: info[k] for k in sums} == pytest.approx(sums, abs=1e-9)
        assert {"pyramid_creation", "sparse_img_align", "reproject",
                "pose_optimizer", "point_optimizer"} <= set(sums)
        if info.get("is_keyframe"):
            assert {"keyframe", "depth_filter"} <= set(sums)


@pytest.mark.parametrize("entry", ["vo_step_donated", "vmapped_vo_step"])
def test_fused_stage_spans_in_stage_order(scene, entry):
    """The fused step's stage spans, in the order they begin, under the
    entry's root, then the donated step's write-back (the batched step:
    under vmap, functional on the CPU)."""
    spans.clear()
    with spans.recording():
        _step(scene, entry)
    rec = sorted(spans.recorded(), key=lambda s: s.id)
    root = rec[0]
    assert root.name == entry and root.parent == -1
    assert [s.name for s in rec[1:]] == STEP_STAGES + (
        ["write_back"] if entry == "vo_step_donated" else [])
    assert all(s.parent == root.id and s.frame == root.frame
               for s in rec[1:])
    for a, b in zip(rec[1:], rec[2:]):
        assert a.host[0] <= a.host[1] <= b.host[0] <= b.host[1]


def test_span_tree_switch_unwind_self_time_and_profiler_ranges():
    """``switch`` closes and opens at one stamp; ``span`` closes what an
    exception left open; a span's host self time leaves out its
    children; under torch.profiler every span is an ``svo.`` range."""
    from torch.profiler import ProfilerActivity, profile
    cpu = torch.device("cpu")
    spans.clear()
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]) \
            as prof:
        with pytest.raises(ZeroDivisionError):
            with spans.span("outer", cpu):
                spans.begin("a", cpu)
                spans.switch("b", cpu)
                spans.begin("c", cpu)
                1 / 0
        with spans.span("after", cpu):
            pass
    rec = {s.name: s for s in spans.recorded()}
    assert set(rec) == {"outer", "a", "b", "c", "after"}
    assert rec["a"].host[1] == rec["b"].host[0]
    assert rec["c"].parent == rec["b"].id
    assert rec["b"].parent == rec["a"].parent == rec["outer"].id
    assert rec["after"].parent == -1
    assert rec["after"].frame != rec["outer"].frame
    sm = spans.summary()
    assert sm["frames"] == 2
    outer = sm["by_name"]["outer"]
    kids = sum(sm["by_name"][k]["host_s"] for k in ("a", "b"))
    assert outer["host_self_s"] == pytest.approx(outer["host_s"] - kids,
                                                 abs=2e-9)
    names = {e.name for e in prof.events()}
    assert {"svo.outer", "svo.a", "svo.b", "svo.c", "svo.after"} <= names


def test_trace_writer_rows_are_made_when_written(tmp_path):
    """A stage time that enters the info dict after it was logged (a
    span read at the next frame) is in the written row."""
    tw = TraceWriter(str(tmp_path), "t")
    info = {"timestamp": 0.5, "proc_time": 0.02, "result": "no_keyframe"}
    tw.log_frame(info)
    info["sparse_img_align"] = 0.004
    with open(tw.flush()) as f:
        row = next(csv.DictReader(f))
    assert float(row["sparse_img_align"]) == 0.004
    assert float(row["tot_time"]) == 0.02


def test_slot_copies_are_counted_by_the_leaves_bytes(scene):
    """``graphed.slot`` counts the state's bytes in on every call (the
    first, which makes the slot, too), ``fresh_copy`` counts them out."""
    st = scene["state0"]
    mb = sum(x.numel() * x.element_size()
             for x in pytree.tree_leaves(st)) / 1e6
    static = ("spans-test",)
    graphed.clear()
    graphed.reset_jit_counts()
    try:
        own = graphed.slot(static, st, scene["imgs"][0])
        assert graphed.slot(static, st, scene["imgs"][0]) is own
        back = graphed.fresh_copy(own)
    finally:
        graphed.clear()
    assert _equal(back, st)
    assert graphed.kept_copy_stats() == pytest.approx(
        {"in_copied_mb": 2 * mb, "out_copied_mb": mb}, rel=1e-12)
    graphed.reset_jit_counts()
    assert graphed.kept_copy_stats() == {"in_copied_mb": 0.0,
                                         "out_copied_mb": 0.0}


# --- on the card ------------------------------------------------------------
CARD_SHAPE = (480, 752)
CARD_FRAMES = 12


@pytest.fixture(scope="module")
def card():
    dev = need_cuda()
    ds = SyntheticDataset(n_frames=CARD_FRAMES + 1, trajectory="circle",
                          radius=0.25, revolutions=0.05, shape=CARD_SHAPE,
                          device=dev)
    cfg = tconfig.fast_preset()
    img0, depth0, T0 = ds.frame(0)
    state0 = fused.seed_first_frame_with_depth(
        img0, T0.inverse(), depth0, ds.cam, cfg, img_shape=CARD_SHAPE,
        device=dev)
    imgs = [ds.frame(i)[0] for i in range(1, CARD_FRAMES + 1)]
    return dict(ds=ds, cfg=cfg, state0=state0, imgs=imgs, first=(img0,
                depth0, T0), grid=grid_dims(CARD_SHAPE[1], CARD_SHAPE[0],
                                            cfg.grid_size))


def _card_steps(card, batch: int):
    """The donated step (batch 0) or the batched step over the frames,
    with spans on, each step's pose read on the host (a closed loop)."""
    cam, cfg, (ncx, ncy) = card["ds"].cam, card["cfg"], card["grid"]
    if batch:
        st = streams.stack_states([card["state0"]] * batch)
    else:
        st = _clone(card["state0"])
    graphed.clear()
    spans.clear()
    with spans.recording():
        for img in card["imgs"]:
            if batch:
                st, out = streams.vmapped_vo_step(
                    st, torch.stack([img] * batch), cam, cfg, ncx, ncy,
                    CARD_SHAPE)
            else:
                st, out = fused.vo_step_donated(st, img, cam, cfg, ncx, ncy,
                                                CARD_SHAPE)
            out.t_wc.cpu()
    return spans.recorded()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [0, 2])
def test_graph_stage_spans_cover_the_replay(card, batch):
    """Every replay after the capture yields the step's stage spans from
    the graph's event nodes, in stage order, together 90-100% of the
    replay's own event time."""
    rec = _card_steps(card, batch)
    assert spans.dropped() == 0
    kids: dict = {}
    for s in rec:
        kids.setdefault(s.parent, []).append(s)
    replays = [s for s in rec if s.name == "replay"]
    assert len(replays) == CARD_FRAMES - 1
    for r in replays:
        stages = sorted(kids[r.id], key=lambda s: s.device[0])
        assert [s.name for s in stages] == STEP_STAGES + ["write_back"]
        assert all(s.host is None for s in stages)
        inside = sum(s.device[1] - s.device[0] for s in stages)
        share = inside / (r.device[1] - r.device[0])
        assert 0.90 <= share <= 1.0 + 1e-3, share
        assert r.device[0] <= stages[0].device[0] \
            and stages[-1].device[1] <= r.device[1] + 1000


def _event_nodes(graph) -> int:
    """Event-record nodes of a captured step graph (kept by
    ``keep_graph``), which holds the mapping stages' two IF nodes; read
    with libcuda's ``cuGraphNodeGetType`` (the runtime's
    ``cudaGraphNodeGetType`` fails on a conditional node that another
    runtime added)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    h = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(h, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(t)) == 0
        kinds.append(t.value)
    assert n.value > 100
    assert kinds.count(13) == 2    # CU_GRAPH_NODE_TYPE_CONDITIONAL
    return kinds.count(7)          # CU_GRAPH_NODE_TYPE_EVENT_RECORD


@pytest.mark.cuda
def test_spans_switch_keys_a_graph_with_event_nodes(card, monkeypatch):
    """The switch is part of the step graph's key; the graph captured
    with spans off has no event-record node, the one captured with them
    on one per stage boundary."""
    cam, cfg, (ncx, ncy) = card["ds"].cam, card["cfg"], card["grid"]
    kept = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: kept(keep_graph=True))
    graphed.clear()
    st = _clone(card["state0"])
    static = fused._static_args(cam, cfg, ncx, ncy, CARD_SHAPE)
    img = card["imgs"][0]
    k_off = graphed.graph_key(static, st, img)
    st, _ = fused.vo_step_donated(st, img, cam, cfg, ncx, ncy, CARD_SHAPE)
    with spans.recording():
        k_on = graphed.graph_key(static, st, img)
        st, _ = fused.vo_step_donated(st, card["imgs"][1], cam, cfg, ncx,
                                      ncy, CARD_SHAPE)
    assert k_on != k_off
    graphs = dict(graphed._graphs)
    assert set(graphs) == {k_off, k_on}
    assert graphs[k_off].marks is None
    assert _event_nodes(graphs[k_off].graph) == 0
    assert _event_nodes(graphs[k_on].graph) \
        == len(graphs[k_on].marks.events) > len(STEP_STAGES)
    graphed.clear()


@pytest.mark.cuda
def test_handler_with_spans_does_not_synchronize(card, monkeypatch):
    """With spans on, ``add_image`` calls no ``torch.cuda.synchronize``
    (a second handler over the same frames, whose stage graphs and the
    anchor the first one made), and after ``flush`` its info holds the
    stage times read from the card's events."""
    img0, depth0, T0 = card["first"]

    def run():
        fh = FrameHandler(card["ds"].cam, card["cfg"], img_shape=CARD_SHAPE)
        fh.set_first_frame_with_depth(img0, T0.inverse(), depth0)
        return [fh.add_image(img) for img in card["imgs"]]
    waits = []
    real = torch.cuda.synchronize
    spans.clear()
    with spans.recording():
        run()
        captures = sum(v["captures"] for v in graphed.jit_stats().values())
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: waits.append(a))
        infos = run()
        monkeypatch.setattr(torch.cuda, "synchronize", real)
    assert sum(v["captures"] for v in graphed.jit_stats().values()) \
        == captures
    assert waits == []
    for info in infos:
        assert 0 < info["sparse_img_align"] < info["add_image"]
        assert info["reproject"] >= info["feature_align"]
    dev = [s for s in spans.recorded() if s.name == "add_image"]
    assert all(s.device[0] < s.device[1] for s in dev)
