"""Multi-stream (data-parallel) visual odometry.

Port of ``rpg_svo_tpu/parallel/streams.py``: serving many camera streams
at once, in two forms over a ``VOState`` with a leading stream axis.

- ``vmapped_vo_step``: B streams in one step on one card,
  ``torch.func.vmap`` over the fused step's phases (``core/fused.py``).
  The step masks every stage by its predicate and reads nothing back to
  the host, so the batch keeps every stream's semantics; kernels K1 and
  K2 are custom ops whose vmap rules launch once for all B streams
  (``ops/tiles.py``, ``ops/align_kernel.py``), so a batched step issues
  about as many launches as one stream's.  Tracking and the finish run
  under vmap; each mapping stage (the depth-filter update, the keyframe
  stages) is a ``graphed.gate`` on the ``any`` of the streams' predicates,
  opened outside the vmap, with the streams under vmap inside it: on the
  card's graph the stage runs only in steps where some stream needs it,
  and a stream that does not is left as it was by its own masks.  On the
  card the batched step is one CUDA graph replay per step, one
  graph-owned slot per B (core/graphed.py): the functional batched step
  followed, outside the vmap, by the donated step's write of every new
  stacked leaf into the slot's (an in-place write of a batch fails under
  vmap); a gate's body writes its stage's results into the stacked
  leaves the same way, inside the gate.  Where a mesh shards the step
  (``cfg.shard_axis``) the stages stay masked, with no IF node, and so do
  the keyframe stages where they hold local BA (``fused._mapping``).
- ``multistream_step`` / ``multistream_scan``: one stream per rank along
  the mesh's ``dp`` axis, each rank stepping its own stream.  They issue
  no collective: streams are independent, so nothing crosses a rank (the
  counterpart of the JAX package's DCN-silence claim).  On a card each
  stream steps through ``vo_step``/``vo_scan``'s graphs.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch.config import Config
from rpg_svo_tpu_torch.core import fused, graphed, spans


def stack_states(states) -> "fused.VOState":
    """Stack B per-stream VOStates into one batched state."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), states[0],
                           *states[1:])


def index_state(batched, i: int):
    """Stream i's VOState from a batched one."""
    return pytree.tree_map(lambda x: x[i], batched)


def _vmapped_step(states, imgs: torch.Tensor, cam, cfg: Config, ncx: int,
                  ncy: int, img_shape: Tuple[int, int]):
    """The batched step, functional: the out-of-place step body's phases,
    tracking and finish under ``torch.func.vmap``, the mapping stages
    each a gate on any stream's predicate (``fused._mapping``) with the
    streams under vmap inside it."""
    def track(s, img):
        return fused._track(s, img, cam, cfg, ncx, ncy, img_shape,
                            inplace=False)
    t = torch.func.vmap(track)(states, imgs)
    m = fused._mapping(t, cam, cfg, ncx, ncy, inplace=False, batched=True)
    if spans.ON:
        spans.end()
    return torch.func.vmap(fused._finish)(states, t, m)


def _vmapped_donated(states, imgs: torch.Tensor, cam, cfg: Config, ncx: int,
                     ncy: int, img_shape: Tuple[int, int]):
    """The body of the batched step's graph: ``_vmapped_step``, then every
    new stacked leaf written into ``states``' storage (outside the vmap).
    Returns ``states``, now the new ones."""
    new, out = _vmapped_step(states, imgs, cam, cfg, ncx, ncy, img_shape)
    if spans.ON:
        spans.begin("write_back", imgs.device)
    graphed.write_back(states, new)
    if spans.ON:
        spans.end()
    return states, out


def vmapped_vo_step(states, imgs: torch.Tensor, cam, cfg: Config, ncx: int,
                    ncy: int, img_shape: Tuple[int, int]):
    """One tracking step for B streams at once, on the states' device.

    states: VOState with leading axis B; imgs (B, H, W).  Returns (states',
    StepOut) with the same leading axis; the camera and config are
    shared, and the input states are left as they were.  On the card a
    replay of the graph of B's slot (core/graphed.run_kept; a capture on
    the slot's first call, which raises if it fails); on the CPU eager.
    With spans on, the call is a span ``vmapped_vo_step`` around the graph
    layer's (its host self time is the stream layer's own)."""
    if spans.ON:
        with spans.span("vmapped_vo_step", imgs.device):
            return _vmapped_vo_step(states, imgs, cam, cfg, ncx, ncy,
                                    img_shape)
    return _vmapped_vo_step(states, imgs, cam, cfg, ncx, ncy, img_shape)


def _vmapped_vo_step(states, imgs: torch.Tensor, cam, cfg: Config,
                     ncx: int, ncy: int, img_shape: Tuple[int, int]):
    if not graphed.on_card(*pytree.tree_leaves(states), imgs):
        return _vmapped_step(states, imgs, cam, cfg, ncx, ncy, img_shape)
    return graphed.run_kept(
        functools.partial(_vmapped_donated, cam=cam, cfg=cfg, ncx=ncx,
                          ncy=ncy, img_shape=img_shape),
        ("vmapped",) + fused._static_args(cam, cfg, ncx, ncy, img_shape),
        states, imgs)


def multistream_step(mesh, states, imgs: torch.Tensor, cam, cfg: Config,
                     ncx: int, ncy: int, img_shape: Tuple[int, int],
                     axis: str = "dp"):
    """One tracking step of this rank's streams along ``axis``.

    states, imgs: this rank's rows of the stream axis (``shard_on(mesh,
    ..., axis)``; one row when the axis has a rank per stream).  Each rank
    runs the step on its own streams; no collective.  Returns (states',
    StepOut) with the same leading axis."""
    new, outs = [], []
    for j in range(imgs.shape[0]):
        s, o = fused.vo_step(index_state(states, j), imgs[j], cam, cfg, ncx,
                             ncy, img_shape)
        new.append(s)
        outs.append(o)
    return stack_states(new), fused.stack_outs(outs)


def multistream_scan(mesh, states, imgs: torch.Tensor, cam, cfg: Config,
                     ncx: int, ncy: int, img_shape: Tuple[int, int],
                     axis: str = "dp"):
    """``vo_scan`` of this rank's streams along ``axis``: each stream
    tracks its own image stack, with NO collective between streams.

    states: this rank's rows; imgs (B_local, T, H, W).  Returns (states',
    StepOut stacked (B_local, T, ...))."""
    new, outs = [], []
    for j in range(imgs.shape[0]):
        s, o = fused.vo_scan(index_state(states, j), imgs[j], cam, cfg, ncx,
                             ncy, img_shape)
        new.append(s)
        outs.append(o)
    return stack_states(new), fused.stack_outs(outs)
