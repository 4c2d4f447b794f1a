"""``core/fused.vo_step_donated``: the fused step that consumes its state,
one CUDA-graph replay per frame (``core/graphed.run``).  It takes a device
float32 image, uploaded here inside the frame's latency.  One stream."""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from svo_bench.entries.common import Result, T_f_w, host_rows, program_setup


class Entry:
    kind = "step"

    def __init__(self, ctx):
        from rpg_svo_tpu_torch.core import fused
        if ctx.streams != 1:
            raise ValueError("the donated step tracks one stream")
        self.fused = fused
        self.cfg, self.cam, (self.ncx, self.ncy) = program_setup(
            ctx.cfg_file)
        self.img_shape = ctx.img_shape
        self.device = ctx.device
        self._spare = []

    def seed(self, imgs, R_wc, t_wc, depths) -> None:
        self.state = self.fused.seed_first_frame_with_depth(
            torch.as_tensor(imgs[0], dtype=torch.float32, device=self.device),
            T_f_w(R_wc[0], t_wc[0], self.device), depths[0], self.cam,
            self.cfg, self.img_shape, device=self.device)

    def warm(self, n_done: int, keyframes: int) -> bool:
        if n_done < 3:          # the first call captures the one graph
            return False
        # two copies for the window's keep / release, made at set-up
        while len(self._spare) < 2:
            self._spare.append(pytree.tree_map(torch.clone, self.state))
        return True

    def step(self, imgs) -> Result:
        img = torch.from_numpy(imgs[0]).to(self.device).to(torch.float32)
        self.state, out = self.fused.vo_step_donated(
            self.state, img, self.cam, self.cfg, self.ncx, self.ncy,
            self.img_shape)
        R_wc, t_wc, flags = host_rows(
            out.R_fw[None], out.t_wc[None],
            torch.stack([out.is_keyframe, out.failed])[None])
        return Result(R_wc, t_wc, flags[:, 0] > 0, flags[:, 1] > 0, [])

    def close(self) -> None:
        """Drops the live state and the spare copies (the held ones
        stay)."""
        self.state = None
        self._spare = []

    def keep(self):
        # the donated step writes its state in place: copy it into a spare
        # (one batched copy per dtype), or a new clone where none is left
        if not self._spare:
            return pytree.tree_map(torch.clone, self.state)
        kept = self._spare.pop()
        torch._foreach_copy_(pytree.tree_leaves(kept),
                             pytree.tree_leaves(self.state))
        return kept

    def release(self, kept) -> None:
        self._spare.append(kept)

    def hold(self, kept, streams) -> dict:
        return {0: kept}

    def leaves(self, held) -> list:
        return pytree.tree_leaves(held)

    def fields(self, held) -> dict:
        return {}

    def map_of(self, held):
        return held.m
