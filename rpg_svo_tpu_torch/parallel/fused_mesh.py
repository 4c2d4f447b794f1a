"""The whole fused VO step on a mesh.

Port of ``rpg_svo_tpu/parallel/fused_mesh.py``: ``vo_step_mesh`` runs the
single-device step (``core/fused.vo_step``) with its two heavy batched
internals, the depth filter's K-compacted epipolar match and local BA's
point blocks, sharded over the mesh's seed/point axis
(``parallel/gspmd.py``): every rank holds the whole state, matches its
rows of the K-domain and builds its rows' share of the reduced camera
system, and all-gathers and all-reduces put the results together.  The
reference's tracking/mapping thread split (svo/src/depth_filter.cpp:
64-112) becomes mapping work partitioned over ranks inside the one step.

Results equal the single-device step's up to the order of float sums.
On a card both entries run through ``vo_step``/``vo_scan``'s CUDA graphs
(core/graphed.py, the ambient mesh in the graph's key): the graph captures
the NCCL collectives after the eager first step has set the communicator
up, and replays them; ``gspmd.record_collectives`` then logs the first
call only.  On gloo (the CPU) the step is eager.
"""

from __future__ import annotations

from typing import Tuple

from rpg_svo_tpu_torch.config import Config
from rpg_svo_tpu_torch.core import fused
from rpg_svo_tpu_torch.parallel.gspmd import axis_layout, use_mesh


def _check_cfg(mesh, cfg: Config, axis: str) -> Config:
    _, size, _ = axis_layout(axis, mesh)
    if cfg.df_update_k and cfg.df_update_k % size:
        raise ValueError(
            f"cfg.df_update_k={cfg.df_update_k} must be a multiple of the "
            f"'{axis}' mesh axis size {size}: the K-compacted seed domain "
            f"is sharded over that axis (parallel/gspmd.py)")
    return cfg.replace(shard_axis=axis)


def vo_step_mesh(mesh, state: "fused.VOState", img, cam, cfg: Config,
                 ncx: int, ncy: int, img_shape: Tuple[int, int],
                 axis: str = "sp"):
    """One fused tracking+mapping step with the mapping internals sharded
    over ``axis``; every rank passes the whole state and image and gets
    the whole result.  cfg.df_update_k must be a multiple of the axis size
    (checked)."""
    cfg_sp = _check_cfg(mesh, cfg, axis)
    with use_mesh(mesh):
        return fused.vo_step(state, img, cam, cfg_sp, ncx, ncy, img_shape)


def vo_scan_mesh(mesh, state: "fused.VOState", imgs, cam, cfg: Config,
                 ncx: int, ncy: int, img_shape: Tuple[int, int],
                 axis: str = "sp"):
    """``vo_scan`` (a whole image stack) with sharded internals; the
    outputs stacked along T."""
    cfg_sp = _check_cfg(mesh, cfg, axis)
    with use_mesh(mesh):
        return fused.vo_scan(state, imgs, cam, cfg_sp, ncx, ncy, img_shape)
