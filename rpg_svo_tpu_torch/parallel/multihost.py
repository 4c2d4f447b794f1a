"""Multi-host (multi-process) execution: process groups over hosts.

Port of ``rpg_svo_tpu/parallel/multihost.py`` to ``torch.distributed``.
JAX runs one process per host with every local device in it; torch runs
one process per device, so a host with n devices holds n ranks.  The
placement rule is the JAX package's:

- ``dp`` (outer): independent camera STREAMS.  Images stay on the rank
  that loaded them and per-frame state never crosses a rank, so
  steady-state tracking issues NO collective (``parallel/streams.py``).
- ``sp`` (inner): the batched internals of one stream (depth-filter
  K-domain, BA point blocks).
- Global jobs (distributed BA over every host's points) all-reduce over
  BOTH axes: the reduced camera system is the only thing that crosses
  hosts, once per GN iteration.

``init_multihost`` starts the process group over TCP: gloo for the CPU
(how the tests run several processes on one machine), NCCL for CUDA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rpg_svo_tpu_torch import resolve_device

# ranks per host and this rank's device, set by init_multihost
_LAYOUT: dict = {}


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int,
                   local_device_count: Optional[int] = None,
                   device=None) -> torch.device:
    """Join (or start, for rank 0) the process group at
    ``tcp://coordinator_address`` as rank ``process_id`` of
    ``num_processes`` (one process per device).  ``local_device_count``
    ranks share a host (default: the host's CUDA cards, 1 on the CPU);
    rank r uses card r mod that count.  Runs on ``cuda`` with NCCL unless
    the caller asks for the CPU (gloo).  Returns this rank's device."""
    dev = resolve_device(device)
    per_host = local_device_count or (
        torch.cuda.device_count() if dev.type == "cuda" else 1)
    if num_processes % per_host:
        raise ValueError(f"{num_processes} ranks do not fill hosts of "
                         f"{per_host}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id % per_host)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _LAYOUT.update(per_host=per_host, device=dev)
    return dev


def _layout() -> dict:
    if not dist.is_initialized() or not _LAYOUT:
        raise RuntimeError("no process group: call init_multihost first")
    return _LAYOUT


def global_mesh(outer: str = "dp", inner: str = "sp",
                inner_size: Optional[int] = None):
    """One mesh over every rank of every host: (hosts * per_host /
    inner_size, inner_size), ranks in order, so the inner axis stays
    within a host.  ``inner_size`` below the ranks per host folds the
    rest into the outer axis (more streams per host)."""
    from torch.distributed.device_mesh import init_device_mesh
    lay = _layout()
    per_host = lay["per_host"]
    inner_size = inner_size or per_host
    if per_host % inner_size:
        raise ValueError(f"inner size {inner_size} does not divide the "
                         f"{per_host} ranks of a host")
    world = dist.get_world_size()
    return init_device_mesh(lay["device"].type,
                            (world // inner_size, inner_size),
                            mesh_dim_names=(outer, inner))


def host_local_rows(mesh, arr, axes: Tuple[str, ...]):
    """This rank's rows of a global array sharded over ``axes`` of
    ``mesh`` (row-major over the axes), from THIS host's rows: the host
    contributes only what it loaded, in the order of the shards its ranks
    hold (``jax.make_array_from_process_local_data``)."""
    lay = _layout()
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh.cpu().numpy()
    dims = [names.index(a) for a in axes]

    def shard_of(rank: int) -> int:
        coord = np.argwhere(grid == rank)[0]
        s = 0
        for d in dims:
            s = s * grid.shape[d] + int(coord[d])
        return s

    rank, per_host = dist.get_rank(), lay["per_host"]
    host = rank // per_host
    mine = sorted({shard_of(r) for r in
                   range(host * per_host, (host + 1) * per_host)})
    arr = torch.as_tensor(arr)
    n = arr.shape[0]
    if n % len(mine):
        raise ValueError(f"{n} host rows do not divide over the host's "
                         f"{len(mine)} shards")
    k = n // len(mine)
    i = mine.index(shard_of(rank))
    return arr[i * k:(i + 1) * k].to(lay["device"])


def replicated(mesh, arr):
    """Identical per-process data, whole on this rank's device."""
    from rpg_svo_tpu_torch.parallel.sharded import replicate
    return replicate(mesh, arr)


def multihost_ba_solve(mesh, prob, n_iter: int = 10,
                       huber_width: float = 0.01, n_var_max: int = 0):
    """Distributed BA over every rank of every host: cameras replicated,
    points sharded over (outer, inner) jointly; the reduced camera
    system's all-reduce is the only collective that crosses hosts.
    ``prob``'s point fields are this rank's rows (``host_local_rows``),
    its cameras whole (``replicated``)."""
    from rpg_svo_tpu_torch.parallel.ba import distributed_ba_solve
    outer, inner = mesh.mesh_dim_names
    return distributed_ba_solve(mesh, prob, n_iter=n_iter,
                                huber_width=huber_width,
                                axis=(outer, inner), n_var_max=n_var_max)
