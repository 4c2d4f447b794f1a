"""``parallel/streams.vmapped_vo_step``: B camera streams stepped together,
one CUDA-graph replay per batched step (the slot of B,
``core/graphed.run_kept``).  It takes a device float32 (B, H, W) stack,
uploaded here inside the step's latency; each stream's frame takes the
step's time."""

from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

from svo_bench.entries.common import Result, T_f_w, host_rows, program_setup


class Entry:
    kind = "step"

    def __init__(self, ctx):
        from rpg_svo_tpu_torch.core import fused
        from rpg_svo_tpu_torch.parallel import streams
        self.fused, self.streams = fused, streams
        self.cfg, self.cam, (self.ncx, self.ncy) = program_setup(
            ctx.cfg_file)
        self.img_shape = ctx.img_shape
        self.device = ctx.device

    def seed(self, imgs, R_wc, t_wc, depths) -> None:
        self.states = self.streams.stack_states([
            self.fused.seed_first_frame_with_depth(
                torch.as_tensor(img, dtype=torch.float32, device=self.device),
                T_f_w(R, t, self.device), d, self.cam, self.cfg,
                self.img_shape, device=self.device)
            for img, R, t, d in zip(imgs, R_wc, t_wc, depths)])

    def warm(self, n_done: int, keyframes: int) -> bool:
        return n_done >= 3      # the first call captures the slot's graph

    def step(self, imgs) -> Result:
        batch = torch.from_numpy(np.stack(imgs)).to(self.device) \
            .to(torch.float32)
        self.states, out = self.streams.vmapped_vo_step(
            self.states, batch, self.cam, self.cfg, self.ncx, self.ncy,
            self.img_shape)
        R_wc, t_wc, flags = host_rows(
            out.R_fw, out.t_wc, torch.stack([out.is_keyframe, out.failed], 1))
        return Result(R_wc, t_wc, flags[:, 0] > 0, flags[:, 1] > 0, [])

    def close(self) -> None:
        """Drops the live state (the kept ones stay)."""
        self.states = None

    def keep(self):
        # the entry leaves its input as it was: the states are kept as
        # they are
        return self.states

    def release(self, kept) -> None:
        pass

    def hold(self, kept, streams) -> dict:
        # a copy of each stream's rows, not the whole batch
        return {b: pytree.tree_map(lambda x: x[b].clone(), kept)
                for b in streams}

    def leaves(self, held) -> list:
        return pytree.tree_leaves(held)

    def fields(self, held) -> dict:
        return {}

    def map_of(self, held):
        return held.m
