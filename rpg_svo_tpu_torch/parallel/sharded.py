"""Device-mesh sharded VO programs.

Port of ``rpg_svo_tpu/parallel/sharded.py`` to ``torch.distributed``.  The
reference's scaling axes become sharded batch dimensions over a mesh:

- ``dp`` (data parallel): independent camera streams tracked in parallel;
- ``sp`` (seed/point parallel): the depth-filter seed pool and the feature
  sets of the optimizers sharded across devices, the 6x6 normal equations
  and the convergence count summed by all-reduces.

One process per device: a JAX process with n devices becomes n ranks, and
each ``shard_map`` becomes code that every rank runs on its local view.
An argument JAX shards on an axis (``P(axis)``) is this rank's rows of it
(``shard_on`` cuts them from the whole array); one JAX replicates
(``P()``) is whole on every rank (``replicate``).  The collectives run on
gloo for CPU tensors and NCCL for CUDA ones (``parallel/multihost.py``
starts the process group).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch import resolve_device
from rpg_svo_tpu_torch.geometry.cameras import project2d
from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.geometry.triangulation import jacobian_xyz2uv
from rpg_svo_tpu_torch.ops.robust import tukey_weight
from rpg_svo_tpu_torch.parallel.gspmd import (
    axis_layout, psum, shard_dim0, use_mesh)


def make_mesh(n_devices: int | None = None,
              axis_names: Tuple[str, str] = ("dp", "sp"),
              dp: int | None = None, device=None):
    """A (dp, sp) DeviceMesh over the world's ranks, in rank order, on
    ``device``'s type (``cuda`` unless the caller asks for the CPU).  The
    mesh spans every rank (one per device); ``dp`` defaults as in JAX: 2
    for an even count of at least 4, else 1."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start it with "
                           "parallel.multihost.init_multihost (one process "
                           "per device)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"the mesh spans the world's {world} ranks (one "
                         f"per device), not {n}")
    if dp is None:
        dp = 2 if n % 2 == 0 and n >= 4 else 1
    if n % dp:
        raise ValueError(f"dp={dp} does not divide {n} ranks")
    return init_device_mesh(dev.type, (dp, n // dp),
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distributed_pose_gn_step(T: SE3, p_w: torch.Tensor, f_meas: torch.Tensor,
                             sqrt_inv_cov: torch.Tensor, valid: torch.Tensor,
                             scale, axis: str = "sp"):
    """One Gauss-Newton step for the pose with the FEATURES SHARDED over
    ``axis`` of the ambient mesh: each rank accumulates its partial 6x6
    normal equations from its rows, one all-reduce sums H, b and chi2, and
    every rank solves the same 6x6 system.  Returns (T', chi2)."""
    p_cam = T.apply(p_w)
    e = (project2d(f_meas) - project2d(p_cam)) * sqrt_inv_cov[:, None]
    e = torch.where(valid[:, None], e, torch.zeros_like(e))
    J = jacobian_xyz2uv(p_cam) * sqrt_inv_cov[:, None, None]
    scale = torch.clamp(torch.as_tensor(scale, dtype=torch.float32,
                                        device=p_w.device), min=1e-12)
    w = tukey_weight(torch.linalg.vector_norm(e, dim=-1) / scale)
    w = torch.where(valid, w, torch.zeros_like(w))
    H = torch.einsum("nij,nik,n->jk", J, J, w)
    b = -torch.einsum("nij,ni,n->j", J, e, w)
    chi2 = torch.sum(torch.sum(e * e, -1) * w)
    H, b, chi2 = psum((H, b, chi2), axis)
    eye = torch.eye(6, device=H.device)
    dT = torch.linalg.solve_ex(H + 1e-12 * eye, b[:, None],
                               check_errors=False)[0][:, 0]
    return SE3.exp(dT) * T, chi2


def sharded_pose_optimize(mesh, T_init: SE3, p_w, f_meas, level, valid,
                          n_iter: int = 10, axis: str = "sp") -> SE3:
    """Pose optimization with the features sharded over ``axis``: p_w,
    f_meas, level and valid are this rank's rows, the pose is replicated;
    every rank returns the same pose."""
    sqrt_inv_cov = 1.0 / torch.exp2(level.to(torch.float32))
    T = T_init
    with use_mesh(mesh):
        for _ in range(n_iter):
            T, _ = distributed_pose_gn_step(T, p_w, f_meas, sqrt_inv_cov,
                                            valid, 1.0, axis)
    return T


def sharded_seed_update(mesh, mu, sigma2, a, b, z_range, x, tau2, active,
                        axis: str = "sp"):
    """The depth filter's Bayesian update with the SEED POOL SHARDED over
    ``axis`` (every argument this rank's rows): a map over the seeds plus
    one all-reduce of the convergence count.  Returns (mu', sigma2', a',
    b', n_converged over every rank)."""
    from rpg_svo_tpu_torch.core.depth_filter import seed_variance_update
    m2, s2, a2, b2 = seed_variance_update(mu, sigma2, a, b, z_range, x,
                                          tau2)
    m2 = torch.where(active, m2, mu)
    s2 = torch.where(active, s2, sigma2)
    a2 = torch.where(active, a2, a)
    b2 = torch.where(active, b2, b)
    conv = active & (torch.sqrt(torch.clamp(s2, min=0.0)) < z_range / 200.0)
    n_conv = psum(torch.sum(conv), axis, mesh)
    return m2, s2, a2, b2, n_conv


def replicate(mesh, tree):
    """Every leaf whole on this rank's device (``P()``)."""
    dev = mesh_device(mesh)
    return pytree.tree_map(lambda x: torch.as_tensor(x).to(dev), tree)


def shard_on(mesh, tree, axis: str = "sp"):
    """This rank's rows of the leading dim of every leaf (``P(axis)``), on
    this rank's device, from the whole arrays."""
    return replicate(mesh, shard_dim0(
        pytree.tree_map(torch.as_tensor, tree), axis, mesh))

