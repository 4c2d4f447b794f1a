"""Map data model: fixed-capacity struct-of-arrays pools.

Port of ``rpg_svo_tpu/core/map.py``.  Keyframes,
points and seeds live in fixed-capacity pools with validity masks; inserts
are masked scatters.  Types and layouts equal the JAX pools one to one
(int32 ids, bool masks, float32 values), so ``core/convert.py`` maps a JAX
state field by field.

Scratch-row convention (as in the JAX package): the last row of every pool
is never handed out as a slot.  The JAX package writes disabled or invalid
inserts there; the port writes nothing for them (``set_rows``).
Point types: DELETED < CANDIDATE < UNKNOWN < GOOD.

Each pool write helper of the step returns the written pool.  With
``inplace`` (the donated step, ``core/fused.vo_step_donated``) it writes
into the pool itself, which the caller then owns; otherwise into a copy,
leaving its input as it was (``vo_step``, which ``torch.func.vmap``
batches).  Both forms write the same values.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from svo_bench.reference.svo.geometry.se3 import SE3
from svo_bench.reference.svo.ops.patches import TILE_R, empty_tiles

TYPE_DELETED = 0
TYPE_CANDIDATE = 1
TYPE_UNKNOWN = 2
TYPE_GOOD = 3

I32 = torch.int32


class KeyframeStore(NamedTuple):
    flat_pyr: torch.Tensor      # (K, Hs, Ws) padded pyramid stacks
    R: torch.Tensor             # (K, 3, 3) T_f_w rotation
    t: torch.Tensor             # (K, 3)
    frame_id: torch.Tensor      # (K,) int32, -1 when free
    active: torch.Tensor        # (K,) bool
    feat_px: torch.Tensor       # (K, F, 2) level-0 px
    feat_f: torch.Tensor        # (K, F, 3) unit bearing
    feat_level: torch.Tensor    # (K, F) int32
    feat_point: torch.Tensor    # (K, F) int32 point id, -1 none
    feat_valid: torch.Tensor    # (K, F) bool
    feat_type: torch.Tensor     # (K, F) int32
    feat_grad: torch.Tensor     # (K, F, 2)
    kp5_dir: torch.Tensor       # (K, 5, 3)
    kp5_depth: torch.Tensor     # (K, 5)
    kp5_valid: torch.Tensor     # (K, 5) bool
    feat_tile: torch.Tensor     # (K, Fs, TILE_R*TILE_R); Fs = F rounded to 8
    feat_tile_xy0: torch.Tensor  # (K, Fs, 2) int32

    @property
    def T_f_w(self) -> SE3:
        return SE3(self.R, self.t)


class PointStore(NamedTuple):
    pos: torch.Tensor           # (P, 3) world position
    ptype: torch.Tensor         # (P,) int32 TYPE_*
    n_succ: torch.Tensor        # (P,) int32
    n_fail: torch.Tensor        # (P,) int32
    last_optim: torch.Tensor    # (P,) int32 frame id of last structure opt
    obs_kf: torch.Tensor        # (P, M) int32 keyframe slot, -1 free
    obs_feat: torch.Tensor      # (P, M) int32
    obs_valid: torch.Tensor     # (P, M) bool
    orig_kf: torch.Tensor       # (P,) int32
    orig_px: torch.Tensor       # (P, 2)
    orig_f: torch.Tensor        # (P, 3)
    orig_level: torch.Tensor    # (P,) int32
    orig_type: torch.Tensor     # (P,) int32
    orig_grad: torch.Tensor     # (P, 2)
    orig_tile: torch.Tensor     # (P, TILE_R*TILE_R)
    orig_tile_xy0: torch.Tensor  # (P, 2) int32

    @property
    def active(self) -> torch.Tensor:
        return self.ptype != TYPE_DELETED

    @property
    def n_obs(self) -> torch.Tensor:
        return torch.sum(self.obs_valid, dim=-1, dtype=torch.int32)


class SeedStore(NamedTuple):
    active: torch.Tensor
    kf_slot: torch.Tensor
    batch_id: torch.Tensor
    px: torch.Tensor
    f: torch.Tensor
    level: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    mu: torch.Tensor
    z_range: torch.Tensor
    sigma2: torch.Tensor
    ftype: torch.Tensor
    grad: torch.Tensor
    tile: torch.Tensor
    tile_xy0: torch.Tensor
    upd_count: torch.Tensor


class MapState(NamedTuple):
    kf: KeyframeStore
    pt: PointStore
    seed: SeedStore
    kf_counter: torch.Tensor    # int32 scalar


def as_flag(enable, device) -> torch.Tensor:
    """A 0-d bool tensor of ``enable`` (a bool or such a tensor), made on
    the device by a fill, not copied from host memory (a copy a CUDA
    graph's capture refuses)."""
    if isinstance(enable, torch.Tensor):
        return enable.to(device)
    return torch.full((), bool(enable), dtype=torch.bool, device=device)


def _tile_rows(v, n: int, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=dev).repeat(n, 1)


def init_map(n_kfs: int, n_feats: int, n_points: int, n_obs: int,
             n_seeds: int, pyr_shape: Tuple[int, int],
             device="cpu") -> MapState:
    dev = torch.device(device)
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731,E501
    full = lambda s, v, dt=I32: torch.full(s, v, dtype=dt, device=dev)  # noqa: E731,E501
    Fs = -(-n_feats // 8) * 8
    T2 = TILE_R * TILE_R
    kf = KeyframeStore(
        flat_pyr=z(n_kfs, *pyr_shape),
        R=torch.eye(3, device=dev).repeat(n_kfs, 1, 1),
        t=z(n_kfs, 3),
        frame_id=full((n_kfs,), -1),
        active=z(n_kfs, dt=torch.bool),
        feat_px=z(n_kfs, n_feats, 2),
        feat_f=_tile_rows([0.0, 0.0, 1.0], n_kfs * n_feats, dev)
        .reshape(n_kfs, n_feats, 3),
        feat_level=z(n_kfs, n_feats, dt=I32),
        feat_point=full((n_kfs, n_feats), -1),
        feat_valid=z(n_kfs, n_feats, dt=torch.bool),
        feat_type=z(n_kfs, n_feats, dt=I32),
        feat_grad=_tile_rows([1.0, 0.0], n_kfs * n_feats, dev)
        .reshape(n_kfs, n_feats, 2),
        kp5_dir=_tile_rows([0.0, 0.0, 1.0], n_kfs * 5, dev)
        .reshape(n_kfs, 5, 3),
        kp5_depth=torch.ones((n_kfs, 5), device=dev),
        kp5_valid=z(n_kfs, 5, dt=torch.bool),
        feat_tile=z(n_kfs, Fs, T2),
        feat_tile_xy0=full((n_kfs, Fs, 2), -1),
    )
    pt = PointStore(
        pos=z(n_points, 3),
        ptype=z(n_points, dt=I32),
        n_succ=z(n_points, dt=I32),
        n_fail=z(n_points, dt=I32),
        last_optim=z(n_points, dt=I32),
        obs_kf=full((n_points, n_obs), -1),
        obs_feat=full((n_points, n_obs), -1),
        obs_valid=z(n_points, n_obs, dt=torch.bool),
        orig_kf=full((n_points,), -1),
        orig_px=z(n_points, 2),
        orig_f=_tile_rows([0.0, 0.0, 1.0], n_points, dev),
        orig_level=z(n_points, dt=I32),
        orig_type=z(n_points, dt=I32),
        orig_grad=_tile_rows([1.0, 0.0], n_points, dev),
        orig_tile=z(n_points, T2),
        orig_tile_xy0=full((n_points, 2), -1),
    )
    seed = SeedStore(
        active=z(n_seeds, dt=torch.bool),
        kf_slot=full((n_seeds,), -1),
        batch_id=z(n_seeds, dt=I32),
        px=z(n_seeds, 2),
        f=_tile_rows([0.0, 0.0, 1.0], n_seeds, dev),
        level=z(n_seeds, dt=I32),
        a=torch.ones((n_seeds,), device=dev),
        b=torch.ones((n_seeds,), device=dev),
        mu=torch.ones((n_seeds,), device=dev),
        z_range=torch.ones((n_seeds,), device=dev),
        sigma2=torch.ones((n_seeds,), device=dev),
        ftype=z(n_seeds, dt=I32),
        grad=_tile_rows([1.0, 0.0], n_seeds, dev),
        tile=z(n_seeds, T2),
        tile_xy0=full((n_seeds, 2), -1),
        upd_count=z(n_seeds, dt=I32),
    )
    return MapState(kf, pt, seed, z(dt=I32))


# ---------------------------------------------------------------------------
# compaction and slot allocation
# ---------------------------------------------------------------------------

def mask_compact(mask: torch.Tensor, k: int):
    """First k set indices of a bool mask, in order: (idx (k,) int64,
    valid (k,) bool); invalid slots hold 0.  A cumsum plus a scatter-max
    (the JAX ``.at[tgt].max``), with no host sync."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (pos < k), pos, torch.full_like(pos, k))
    out = torch.zeros((k + 1,), dtype=torch.int64, device=mask.device)
    out = out.scatter_reduce(0, tgt, torch.arange(n, device=mask.device),
                             reduce="amax", include_self=True)
    valid = torch.arange(k, device=mask.device) \
        < torch.clamp(pos[-1] + 1, min=0)
    return torch.where(valid, out[:k], torch.zeros_like(out[:k])), valid


def mask_compact_priority(mask: torch.Tensor, k: int,
                          priority: torch.Tensor):
    """Top-k set indices of a bool mask, highest ``priority`` first and
    lower index first among ties (``lax.top_k``): (idx (k,) int64, valid
    (k,) bool); invalid slots hold 0."""
    key = torch.where(mask, priority.to(torch.float32),
                      torch.full_like(priority, float("-inf"),
                                      dtype=torch.float32))
    val, idx = torch.sort(key, descending=True, stable=True)
    valid = torch.isfinite(val[:k])
    return torch.where(valid, idx[:k], torch.zeros_like(idx[:k])), valid


def free_slots(active: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of up to n free slots (-1 padded), int32 (n,)."""
    idx, ok = mask_compact(~active, n)
    return torch.where(ok, idx, torch.full_like(idx, -1)).to(I32)


def alloc_scatter(arr: torch.Tensor, slots: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """arr with values written at slots; slots == -1 write the scratch
    (last) row.  Returns a new tensor."""
    sw = torch.where(slots >= 0, slots, torch.full_like(slots, arr.shape[0] - 1))
    return arr.index_put((sw.to(torch.int64),), values)


def set_rows(arr: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
             ok: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """arr with values written at idx where ok; rows with ok False write
    nothing, so an invalid row never clobbers a valid write to the same
    index; valid indices must be distinct.  Invalid rows are redirected to
    a spare row: out of place an extra row that is dropped; in place the
    pool's scratch (last) row, which they rewrite with its own values, so
    there no valid index may be the last row."""
    n = arr.shape[0]
    spare = n - 1 if inplace else n
    tgt = torch.where(ok, idx.to(torch.int64), torch.full_like(
        idx, spare, dtype=torch.int64))
    if not inplace:
        return torch.cat([arr, arr[:1]]).index_put((tgt,), values)[:n]
    keep = ok.reshape(ok.shape + (1,) * (arr.dim() - 1))
    return arr.index_put_((tgt,), torch.where(keep, values, arr[spare]))


# ---------------------------------------------------------------------------
# keyframe queries
# ---------------------------------------------------------------------------

def kf_positions(kf: KeyframeStore) -> torch.Tensor:
    """World camera centers of all KF slots (K, 3): -R^T t."""
    return -torch.sum(kf.R * kf.t[:, :, None], dim=1)


def overlapping_kfs(kf: KeyframeStore, T_cur: SE3, cam) -> torch.Tensor:
    """Bool (K,): some of a KF's 5 key points project into the frame
    (map.cpp:106-127)."""
    kp_ref = kf.kp5_dir * kf.kp5_depth[..., None]
    T_w_kf = SE3(kf.R, kf.t).inverse()
    p_w = T_w_kf.apply(kp_ref.transpose(0, 1))            # (5, K, 3)
    p_cur = T_cur.apply(p_w)
    px = cam.world2cam(p_cur)
    vis = cam.is_in_frame(px) & (p_cur[..., 2] > 0.0) \
        & kf.kp5_valid.transpose(0, 1)
    return torch.any(vis, dim=0) & kf.active


def furthest_kf(kf: KeyframeStore, pos_w: torch.Tensor) -> torch.Tensor:
    d = torch.linalg.vector_norm(kf_positions(kf) - pos_w, dim=-1)
    d = torch.where(kf.active, d, torch.full_like(d, float("-inf")))
    return torch.argmax(d).to(I32)


def closest_kf(kf: KeyframeStore, pos_w: torch.Tensor) -> torch.Tensor:
    d = torch.linalg.vector_norm(kf_positions(kf) - pos_w, dim=-1)
    d = torch.where(kf.active, d, torch.full_like(d, float("inf")))
    return torch.argmax(-d).to(I32)


def n_active_kfs(m: MapState) -> torch.Tensor:
    return torch.sum(m.kf.active)


# ---------------------------------------------------------------------------
# mutations
# ---------------------------------------------------------------------------

def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median ignoring NaN, averaging the two middle values for an even
    count (jnp.nanmedian; torch.nanmedian takes the lower one)."""
    n = torch.sum(~torch.isnan(x))
    s = torch.sort(torch.where(torch.isnan(x),
                               torch.full_like(x, float("inf")), x))[0]
    lo = torch.clamp((n - 1) // 2, min=0).reshape(1)
    hi = torch.clamp(n // 2, min=0).reshape(1)
    med = 0.5 * s.index_select(0, lo)[0] + 0.5 * s.index_select(0, hi)[0]
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def _kp5(feat_px, feat_f, feat_valid, feat_depth):
    """5 key points: the most central valid feature with depth plus the
    corner-most one in each quadrant (Frame::setKeyPoints)."""
    nan = torch.full_like(feat_px[:, 0], float("nan"))
    u, v = feat_px[:, 0], feat_px[:, 1]
    cu = _nanmedian(torch.where(feat_valid, u, nan))
    cv = _nanmedian(torch.where(feat_valid, v, nan))
    du = u - torch.where(torch.isnan(cu), torch.zeros_like(cu), cu)
    dv = v - torch.where(torch.isnan(cv), torch.zeros_like(cv), cv)
    ninf = torch.full_like(du, float("-inf"))
    scores = torch.stack([
        -(torch.abs(du) + torch.abs(dv)),
        torch.where((du >= 0) & (dv >= 0), du * dv, ninf),
        torch.where((du >= 0) & (dv < 0), -du * dv, ninf),
        torch.where((du < 0) & (dv < 0), du * dv, ninf),
        torch.where((du < 0) & (dv >= 0), -du * dv, ninf),
    ])
    has_depth = feat_valid & torch.isfinite(feat_depth) & (feat_depth > 0)
    scores = torch.where(has_depth[None, :], scores,
                         torch.full_like(scores, float("-inf")))
    kp_idx = torch.argmax(scores, dim=1)
    kp_valid = torch.isfinite(torch.amax(scores, dim=1))
    return feat_f[kp_idx], feat_depth[kp_idx], kp_valid


def pad_rows(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    """a with its leading axis padded to n rows of ``fill``."""
    if a.shape[0] == n:
        return a
    pad = torch.full((n - a.shape[0],) + tuple(a.shape[1:]), fill,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


def add_keyframe(m: MapState, stack: torch.Tensor, T_f_w: SE3,
                 frame_id: torch.Tensor, feat_px, feat_f, feat_level,
                 feat_point, feat_valid, feat_depth, feat_type=None,
                 feat_grad=None, feat_tile=None, feat_tile_xy0=None,
                 enable=True, inplace: bool = False
                 ) -> Tuple[MapState, torch.Tensor]:
    """Insert a keyframe into the first free slot (never the scratch row);
    returns (map, slot).  ``enable`` may be a 0-d bool tensor: when it is
    False (or no slot is free) the slot is -1 and every field keeps its
    values (each field's row is written with its own old values, so no
    host read decides anything).  With ``inplace`` the pools are written
    in place: one row, where a copy would move the whole pyramid pool."""
    kf = m.kf
    F = feat_px.shape[0]
    dev = feat_px.device
    if feat_type is None:
        feat_type = torch.zeros((F,), dtype=I32, device=dev)
    if feat_grad is None:
        feat_grad = _tile_rows([1.0, 0.0], F, dev)
    if feat_tile is None:
        feat_tile, feat_tile_xy0 = empty_tiles(F, dev)
    slot = free_slots(kf.active[:-1], 1)[0]
    slot = torch.where(as_flag(enable, dev), slot,
                       torch.full_like(slot, -1))
    ok = slot >= 0
    sw = torch.clamp(slot, min=0).to(torch.int64).reshape(1)
    kp_dir, kp_depth, kp_valid = _kp5(feat_px, feat_f, feat_valid, feat_depth)
    Fs = kf.feat_tile.shape[1]

    def put(arr, val):
        val = val.reshape((1,) + tuple(arr.shape[1:])).to(arr.dtype)
        row = torch.where(ok, val, arr.index_select(0, sw))
        if inplace:
            return arr.index_put_((sw,), row)
        return arr.index_put((sw,), row)

    kf = kf._replace(
        flat_pyr=put(kf.flat_pyr, stack),
        R=put(kf.R, T_f_w.R), t=put(kf.t, T_f_w.t),
        frame_id=put(kf.frame_id, frame_id),
        active=put(kf.active, torch.ones((), dtype=torch.bool, device=dev)),
        feat_px=put(kf.feat_px, feat_px), feat_f=put(kf.feat_f, feat_f),
        feat_level=put(kf.feat_level, feat_level),
        feat_point=put(kf.feat_point, feat_point),
        feat_type=put(kf.feat_type, feat_type),
        feat_grad=put(kf.feat_grad, feat_grad),
        feat_valid=put(kf.feat_valid, feat_valid),
        kp5_dir=put(kf.kp5_dir, kp_dir),
        kp5_depth=put(kf.kp5_depth, kp_depth),
        kp5_valid=put(kf.kp5_valid, kp_valid),
        feat_tile=put(kf.feat_tile, pad_rows(feat_tile, Fs, 0)),
        feat_tile_xy0=put(kf.feat_tile_xy0, pad_rows(feat_tile_xy0, Fs, -1)),
    )
    return m._replace(kf=kf), slot


def alloc_points(pt: PointStore, pos, ptype_val: int, orig_kf, orig_px,
                 orig_f, orig_level, valid, orig_type=None, orig_grad=None,
                 orig_tile=None, orig_tile_xy0=None, inplace: bool = False
                 ) -> Tuple[PointStore, torch.Tensor]:
    """Give row j of the batch the j-th free pool slot where valid;
    returns (store, slot ids (N,) int32, -1 where not allocated)."""
    N = valid.shape[0]
    dev = valid.device
    if orig_type is None:
        orig_type = torch.zeros((N,), dtype=I32, device=dev)
    if orig_grad is None:
        orig_grad = _tile_rows([1.0, 0.0], N, dev)
    if orig_tile is None:
        orig_tile, orig_tile_xy0 = empty_tiles(N, dev)
    slots = free_slots(pt.active[:-1], N)
    slots = torch.where(valid, slots, torch.full_like(slots, -1))
    ok = slots >= 0
    zi = torch.zeros((N,), dtype=I32, device=dev)

    def put(arr, val):
        return set_rows(arr, slots, val, ok, inplace)

    pt = pt._replace(
        pos=put(pt.pos, pos),
        ptype=put(pt.ptype, torch.full_like(zi, ptype_val)),
        n_succ=put(pt.n_succ, zi),
        n_fail=put(pt.n_fail, zi),
        last_optim=put(pt.last_optim, zi),
        obs_valid=put(pt.obs_valid, torch.zeros(
            (N, pt.obs_valid.shape[1]), dtype=torch.bool, device=dev)),
        orig_kf=put(pt.orig_kf, orig_kf),
        orig_px=put(pt.orig_px, orig_px),
        orig_f=put(pt.orig_f, orig_f),
        orig_level=put(pt.orig_level, orig_level),
        orig_type=put(pt.orig_type, orig_type),
        orig_grad=put(pt.orig_grad, orig_grad),
        orig_tile=put(pt.orig_tile, orig_tile),
        orig_tile_xy0=put(pt.orig_tile_xy0, orig_tile_xy0),
    )
    return pt, slots


def add_point_observations(pt: PointStore, point_ids, kf_slot, feat_idx,
                           valid, inplace: bool = False) -> PointStore:
    """Append one (kf_slot, feat_idx) observation per valid point at its
    first free observation slot, or over the ring slot n_succ % M when
    full (Point::addFrameRef with a cap).  Point ids must be distinct."""
    ok = valid & (point_ids >= 0)
    pid = torch.where(ok, point_ids, torch.zeros_like(point_ids)) \
        .to(torch.int64)
    free = ~pt.obs_valid[pid]
    M = free.shape[1]
    slot = torch.argmax(free.to(torch.int8), dim=1)
    has_free = torch.any(free, dim=1)
    slot = torch.where(has_free, slot, (pt.n_succ[pid] % M).to(torch.int64))
    P = pt.obs_kf.shape[0]
    flat = pid * M + slot

    def put(arr, val):
        # one row per (point, observation) cell; the flattened table's
        # last row is a cell of the scratch point, which no valid id names
        return set_rows(arr.reshape(-1), flat, val.to(arr.dtype), ok,
                        inplace).view(P, M)

    return pt._replace(
        obs_kf=put(pt.obs_kf, kf_slot),
        obs_feat=put(pt.obs_feat, feat_idx),
        obs_valid=put(pt.obs_valid, torch.ones_like(ok)))


def delete_keyframe(m: MapState, slot: torch.Tensor) -> MapState:
    """Map::safeDeleteFrame (map.cpp:79-99) for a 0-d slot, -1 for none:
    deactivate the keyframe, drop the observations on it, delete the
    UNKNOWN/GOOD points it leaves with fewer than 2 observations and the
    candidates that originate on it, and kill the seeds it spawned."""
    kf = m.kf
    ok = slot >= 0
    here = (torch.arange(kf.active.shape[0], device=slot.device) == slot)
    kf = kf._replace(
        active=kf.active & ~here,
        frame_id=torch.where(here, torch.full_like(kf.frame_id, -1),
                             kf.frame_id),
        feat_valid=kf.feat_valid & ~here[:, None])
    pt = m.pt
    hit = pt.obs_valid & (pt.obs_kf == slot) & ok
    obs_valid = pt.obs_valid & ~hit
    n_obs = torch.sum(obs_valid, dim=-1)
    starved = (n_obs < 2) & (pt.ptype >= TYPE_UNKNOWN) & torch.any(hit, -1)
    cand_dead = (pt.ptype == TYPE_CANDIDATE) & (pt.orig_kf == slot) & ok
    ptype = torch.where(starved | cand_dead,
                        torch.full_like(pt.ptype, TYPE_DELETED), pt.ptype)
    seed = m.seed
    seed = seed._replace(active=seed.active & ~((seed.kf_slot == slot) & ok))
    return m._replace(kf=kf, pt=pt._replace(obs_valid=obs_valid, ptype=ptype),
                      seed=seed)


def scrub_dead_references(m: MapState) -> MapState:
    """Invalidate keyframe features and observations of deleted points
    (map.cpp:60-77, in bulk)."""
    kf, pt = m.kf, m.pt
    pid = torch.clamp(kf.feat_point, 0, pt.ptype.shape[0] - 1).to(torch.int64)
    has_pt = kf.feat_point >= 0
    alive = pt.ptype[pid] != TYPE_DELETED
    feat_valid = kf.feat_valid & (~has_pt | alive)
    feat_point = torch.where(has_pt & ~alive,
                             torch.full_like(kf.feat_point, -1),
                             kf.feat_point)
    obs_valid = pt.obs_valid & (pt.ptype != TYPE_DELETED)[:, None]
    return m._replace(kf=kf._replace(feat_valid=feat_valid,
                                     feat_point=feat_point),
                      pt=pt._replace(obs_valid=obs_valid))


def transform_map(m: MapState, R: torch.Tensor, t: torch.Tensor,
                  s) -> MapState:
    """Similarity transform of the whole map (Map::transform, map.cpp:
    176-193): points and camera centres map through p' = s R p + t,
    camera orientations rotate by R, and the seeds' inverse depths (and
    keyframe key-point depths) scale with s."""
    kf = m.kf
    pos_new = s * torch.einsum("ij,kj->ki", R, kf_positions(kf)) + t
    rot = torch.einsum("ij,kjl->kil", R, kf.R.transpose(-1, -2))
    T_f_w = SE3(rot, pos_new).inverse()
    seed = m.seed
    return m._replace(
        kf=kf._replace(R=T_f_w.R, t=T_f_w.t, kp5_depth=kf.kp5_depth * s),
        pt=m.pt._replace(pos=s * torch.einsum("ij,pj->pi", R, m.pt.pos) + t),
        seed=seed._replace(mu=seed.mu / s, sigma2=seed.sigma2 / (s * s),
                           z_range=seed.z_range / s))
