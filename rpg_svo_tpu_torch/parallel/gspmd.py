"""Sharding of the fused step's batched internals over a mesh axis.

Port of ``rpg_svo_tpu/parallel/gspmd.py``.  The JAX step annotates the
leading dim of its two heavy batched domains (the depth filter's
K-compacted epipolar match and local BA's point blocks) with a sharding
constraint when ``Config.shard_axis`` names a mesh axis, and XLA places
the collectives.  torch has no GSPMD, so both halves of what XLA places
are explicit here:

- ``shard_dim0`` narrows each leaf to this rank's rows of the axis (a
  rank holds its local view, one process per device);
- ``gather_dim0`` all-gathers the rows back (the K-sized or P-sized
  outputs), ``psum`` all-reduces partial sums (the reduced camera system).

Both are no-ops when the axis is empty, so the single-device step issues
no collective and runs as it did.  The mesh is ambient: ``use_mesh(mesh)``
around the call, the counterpart of ``jax.set_mesh``
(``parallel/fused_mesh.py``).  Every collective of the parallel layer goes
through this module; inside ``record_collectives()`` each one issued is
logged as (kind, axis, bytes), which the tests and ``chip_smoke.py`` read
(a CUDA graph's capture issues none, and its replays log nothing).
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple, Union

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

Axis = Union[str, Tuple[str, ...]]

_MESHES: list = []
# the open logs of record_collectives(), innermost last
_LOGS: List[list] = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``torch.distributed`` DeviceMesh) the ambient mesh
    for the calls inside (``jax.set_mesh``)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def ambient_mesh():
    """The ambient mesh, or None outside ``use_mesh``."""
    return _MESHES[-1] if _MESHES else None


def current_mesh():
    if not _MESHES:
        raise RuntimeError("no ambient mesh: wrap the call in "
                           "`with parallel.gspmd.use_mesh(mesh):`")
    return _MESHES[-1]


def axis_layout(axis: Axis, mesh=None):
    """(process group, size, this rank's index) of a mesh axis, or of a
    tuple of axes taken together (row-major, as ``P((outer, inner))``)."""
    mesh = mesh if mesh is not None else current_mesh()
    names = tuple(mesh.mesh_dim_names)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(axes) == 1:
        return (mesh.get_group(axes[0]), mesh.size(names.index(axes[0])),
                mesh.get_local_rank(axes[0]))
    if axes != names:
        raise ValueError(f"axes {axes} must be one axis or all of the "
                         f"mesh's {names}, in order")
    ranks = mesh.mesh.reshape(-1).tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError("a collective over every axis needs a mesh that "
                         "lays the world's ranks out in order")
    return dist.group.WORLD, len(ranks), dist.get_rank()


@contextlib.contextmanager
def record_collectives():
    """Yields a list that gets (kind, axis, bytes) of every collective
    issued inside the block, in order; nothing is kept outside one."""
    log: List[Tuple[str, Axis, int]] = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _record(kind: str, axis: Axis, t: torch.Tensor) -> None:
    # a CUDA graph's capture issues nothing: its replays are counted by
    # the profiler's NCCL kernel events (core/graphed.py)
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    for log in _LOGS:
        log.append((kind, axis, t.numel() * t.element_size()))


def _leaves(tree):
    return pytree.tree_flatten(tree)


def psum(tree, axis: Axis, mesh=None):
    """Sums of every tensor leaf over the ranks of ``axis``, in ONE
    all-reduce (the leaves travel packed in a float32 buffer, integer
    leaves in their own int64 one); the tree as it is for an empty
    axis."""
    if not axis:
        return tree
    group, _, _ = axis_layout(axis, mesh)
    leaves, spec = _leaves(tree)
    out = list(leaves)
    for kind in (torch.float32, torch.int64):
        idx = [i for i, a in enumerate(leaves)
               if (a.is_floating_point() == (kind is torch.float32))]
        if not idx:
            continue
        buf = torch.cat([leaves[i].reshape(-1).to(kind) for i in idx])
        _record("all_reduce", axis, buf)
        dist.all_reduce(buf, group=group)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = buf[off:off + n].reshape(leaves[i].shape) \
                .to(leaves[i].dtype)
            off += n
    return pytree.tree_unflatten(out, spec)


def shard_dim0(tree, axis: Axis, mesh=None):
    """This rank's rows of the leading dim of every tensor leaf (0-d leaves
    as they are); the tree as it is for an empty axis.  The leading dim
    must divide over the axis."""
    if not axis:
        return tree
    _, size, idx = axis_layout(axis, mesh)

    def one(a):
        if not isinstance(a, torch.Tensor) or a.dim() == 0:
            return a
        n = a.shape[0]
        if n % size:
            raise ValueError(f"leading dim {n} does not divide over the "
                             f"{size} ranks of axis {axis!r}")
        return a.narrow(0, idx * (n // size), n // size)

    return pytree.tree_map(one, tree)


def gather_dim0(tree, axis: Axis, mesh=None):
    """Every rank's rows of each tensor leaf, concatenated in rank order
    along the leading dim, in ONE all-gather (the leaves travel as the
    bytes of one buffer, so bools, ints and floats come back exact); the
    tree as it is for an empty axis."""
    if not axis:
        return tree
    group, size, _ = axis_layout(axis, mesh)
    leaves, spec = _leaves(tree)
    n = leaves[0].shape[0]
    cols = [a.reshape(n, -1).contiguous().view(torch.uint8) for a in leaves]
    buf = torch.cat(cols, dim=1)
    parts = [torch.empty_like(buf) for _ in range(size)]
    _record("all_gather", axis, buf)
    dist.all_gather(parts, buf, group=group)
    full = torch.cat(parts)
    out, off = [], 0
    for a, c in zip(leaves, cols):
        w = c.shape[1]
        out.append(full[:, off:off + w].contiguous().view(a.dtype)
                   .reshape((size * n,) + tuple(a.shape[1:])))
        off += w
    return pytree.tree_unflatten(out, spec)
