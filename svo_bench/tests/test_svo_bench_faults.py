"""A whole run of small cells on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: ``correct`` holds for
the sound program and falls for each fault a cell can have and for the
low-precision control."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch
import torch.utils._pytree as pytree

from svo_bench import harness

DATA = Path(__file__).resolve().parent / "data"
BENCH = json.loads((DATA / "BENCHMARK.json").read_text())
SEED = 2**31 + 11


def run(cell, control=False, seconds=2.0):
    out, info = harness.run(cell, SEED, seconds, False, BENCH,
                            torch.device("cpu"), time.perf_counter(),
                            root=DATA, control=control)
    return out, info


@pytest.mark.parametrize("cell", ["tiny-fast-handler",
                                  "tiny-accurate-handler", "tiny-fast-step",
                                  "tiny-fast-streams2"])
def test_sound_run_is_correct(cell):
    # the batch of two steps slowest on the CPU: a window long enough
    # for a keyframe
    out, info = run(cell, seconds=8.0 if "streams" in cell else 2.0)
    assert out["correct"], (out["checks"], info)
    assert out["failed"] == 0 and info["samples"] > 0
    # every entry's check reaches a keyframe frame of the window
    assert info["sample_keyframes"] > 0
    # the warm-up filled the map to its cap: every frame of the window
    # ran on a full map
    assert info["warm_keyframes"] >= 10
    assert list(out)[-1] == "checks"


def _failed_numbers(out):
    return sorted(k for k, c in out["checks"].items()
                  if c["value"] > c["limit"])


def test_control_is_not_correct():
    out, _ = run("tiny-accurate-handler", control=True)
    assert not out["correct"] and _failed_numbers(out)


def _pose_rows(state):
    return state.R.clone(), state.t.clone()


def _frozen_step(orig):
    """A donated or batched step that returns its state unchanged."""
    def step(state, img, *args):
        keep = pytree.tree_map(torch.clone, state)
        new, out = orig(state, img, *args)
        pytree.tree_map(lambda a, b: a.copy_(b), new, keep)
        t_wc = -(keep.R.transpose(-1, -2) * keep.t[..., None, :]).sum(-1)
        return new, out._replace(R_fw=keep.R, t_wc=t_wc)
    return step


def _altered_step(orig):
    """A step whose pose is altered where it is produced."""
    def step(state, img, *args):
        new, out = orig(state, img, *args)
        return new, out._replace(t_wc=out.t_wc + 1e-3)
    return step


def _half_batch(orig):
    """A batched step that leaves out its second half of streams."""
    def step(states, imgs, *args):
        new, out = orig(states, imgs, *args)
        h = imgs.shape[0] // 2
        new = pytree.tree_map(
            lambda n, o: torch.cat([n[:h], o[h:]]), new, states)
        t_wc = -(states.R.transpose(-1, -2) * states.t[..., None, :]).sum(-1)
        out = out._replace(R_fw=torch.cat([out.R_fw[:h], states.R[h:]]),
                           t_wc=torch.cat([out.t_wc[:h], t_wc[h:]]))
        return new, out
    return step


def _no_keyframe_stages(orig):
    """Keyframe frames whose insertion, seed init and map cap leave the
    map as it was (the step still reports a keyframe)."""
    def stages(m, *args, **kw):
        return m
    return stages


def _frozen_handler(orig):
    def add_image(self, img, *args, **kw):
        keep = self.map, self.last_frame
        info = orig(self, img, *args, **kw)
        self.map, self.last_frame = keep
        return info
    return add_image


def _altered_handler(orig):
    def add_image(self, img, *args, **kw):
        info = orig(self, img, *args, **kw)
        self.last_frame = self.last_frame._replace(
            t=self.last_frame.t + 1e-3)
        return info
    return add_image


@pytest.mark.parametrize("cell,target,fault", [
    ("tiny-fast-handler", "handler", _frozen_handler),
    ("tiny-fast-handler", "handler", _altered_handler),
    ("tiny-fast-step", "step", _frozen_step),
    ("tiny-fast-step", "step", _altered_step),
    ("tiny-fast-step", "keyframe_stages", _no_keyframe_stages),
    ("tiny-fast-streams2", "streams", _frozen_step),
    ("tiny-fast-streams2", "streams", _altered_step),
    ("tiny-fast-streams2", "streams", _half_batch),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(monkeypatch, cell, target, fault):
    from rpg_svo_tpu_torch.core import fused, pipeline
    from rpg_svo_tpu_torch.parallel import streams
    owner, name = {"handler": (pipeline.FrameHandler, "add_image"),
                   "step": (fused, "vo_step_donated"),
                   "keyframe_stages": (fused, "_keyframe_stages"),
                   "streams": (streams, "vmapped_vo_step")}[target]
    monkeypatch.setattr(owner, name, fault(getattr(owner, name)))
    try:
        out, info = run(cell)
    except RuntimeError as e:
        # the run stops and prints no result: as good as not correct
        assert "tracking failed" in str(e)
        return
    assert not out["correct"], (out["checks"], info)
    assert _failed_numbers(out) or out["failed"]


@pytest.mark.cuda
def test_one_run_on_the_card():
    """One short run of the first cell on the card, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    out, _ = harness.run(cell, SEED, 3.0, False, bench,
                         torch.device("cuda", 0), time.perf_counter())
    assert out["correct"], out["checks"]
