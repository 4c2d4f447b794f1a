"""``core/pipeline.FrameHandler.add_image``: the public path of the live
tool and the offline driver (its stages replay as CUDA graphs,
``core/graphed.jit``).  It takes the host uint8 array; its own ``_image``
uploads it.  One stream."""

from __future__ import annotations

import numpy as np
import torch.utils._pytree as pytree

from svo_bench.entries.common import Result, T_f_w, host_rows, program_setup
from svo_bench.reference.runner import HANDLER_FIELDS


class Entry:
    kind = "handler"

    def __init__(self, ctx):
        from rpg_svo_tpu_torch.core import pipeline
        if ctx.streams != 1:
            raise ValueError("the handler tracks one stream")
        self.pipeline = pipeline
        cfg, cam, _ = program_setup(ctx.cfg_file)
        self.fh = pipeline.FrameHandler(cam, cfg, ctx.img_shape,
                                        device=ctx.device)
        self._since_kf = 0

    def seed(self, imgs, R_wc, t_wc, depths) -> None:
        self.fh.set_first_frame_with_depth(
            imgs[0], T_f_w(R_wc[0], t_wc[0], self.fh.device), depths[0])

    def warm(self, n_done: int, keyframes: int) -> bool:
        # two frames past a keyframe, so that both parities of the seed
        # update ran after its captures
        return n_done >= 3 and self._since_kf >= 2

    def step(self, imgs) -> Result:
        info = self.fh.add_image(imgs[0])
        lf = self.fh.last_frame
        R_wc, t, _ = host_rows(lf.R[None], lf.t[None], lf.t[None, :0])
        t_wc = -np.einsum("bij,bj->bi", R_wc, t)
        kf = info["result"] == self.pipeline.RESULT_IS_KEYFRAME
        self._since_kf = 0 if kf else self._since_kf + 1
        failed = info["result"] == self.pipeline.RESULT_FAILURE \
            or self.fh.stage != self.pipeline.STAGE_DEFAULT_FRAME
        return Result(R_wc, t_wc, np.array([kf]), np.array([failed]), [info])

    def close(self) -> None:
        """Drops the live state (the kept ones stay)."""
        self.fh = None

    def keep(self):
        # the handler's stages are functional (a stage graph's outputs are
        # fresh tensors, the host glue writes nothing in place), so the
        # state before a step is its tensors as they are
        fh = self.fh
        return (fh.map, fh.last_frame), {k: getattr(fh, k)
                                         for k in HANDLER_FIELDS}

    def release(self, kept) -> None:
        pass

    def hold(self, kept, streams) -> dict:
        return {0: kept}

    def leaves(self, held) -> list:
        return pytree.tree_leaves(held[0])

    def fields(self, held) -> dict:
        return held[1]

    def map_of(self, held):
        return held[0][0]
