"""The fused per-frame step, and the first-frame seeding.

Port of ``rpg_svo_tpu/core/fused.py``: the whole per-frame update of the
JAX ``_vo_step`` on the card,

1. the padded pyramid of the new image;
2. sparse image alignment against the last frame (or, relocalizing, the
   closest keyframe) -- kernel K2, one launch;
3. reprojection of the map with 2-D feature alignment (tiles by K1);
4. pose optimization;
5. structure optimization of the longest-unoptimized points;
6. the quality gates and the keyframe policy;
7. the depth-filter update (epipolar search, K1 for its align2D), every
   ``df_update_every``-th frame and on keyframes, when a seed has work;
8. on keyframes: insertion with feature tiles (K1), observation binding
   and candidate promotion, local BA (accurate preset), seed detection
   with tiles (K1) and seed init, and the map cap;

and the stage transition.  ``cfg.ablate`` may stub "kf" (no keyframe is
ever taken) and "df" (no seed update), as in JAX.

The JAX step chooses branches with ``lax.cond``; here every branch runs
and its result is kept or dropped with ``torch.where`` or a mask, so
nothing in the step reads a value back to the host and the step can later
be captured in a CUDA graph.  ``seed_first_frame_with_depth`` ports
``FrameHandler.set_first_frame_with_depth`` (core/pipeline.py:202-256) as
a function returning a ``VOState`` (``core/pipeline.FrameHandler`` seeds
through it), and ``state_from_handler`` starts the step from a
bootstrapped ``FrameHandler``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rpg_svo_tpu_torch import resolve_device
from rpg_svo_tpu_torch.config import Config
from rpg_svo_tpu_torch.core import depth_filter as df
from rpg_svo_tpu_torch.core import map as svomap
from rpg_svo_tpu_torch.core.frame import scene_depth
from rpg_svo_tpu_torch.core.local_ba import run_local_ba
from rpg_svo_tpu_torch.core.map import MapState
from rpg_svo_tpu_torch.core.reprojector import reproject_map
from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.ops.detector import cell_index, detect_features, grid_dims
from rpg_svo_tpu_torch.ops.patches import extract_tiles
from rpg_svo_tpu_torch.ops.point_opt import optimize_points
from rpg_svo_tpu_torch.ops.pose_opt import optimize_pose
from rpg_svo_tpu_torch.ops.pyramid import build_padded_pyramid, pyramid_shapes
from rpg_svo_tpu_torch.ops.sparse_align import sparse_img_align
from rpg_svo_tpu_torch.ops.tiles import PaddedPyramid, padded_layout

STAGE_DEFAULT = 0
STAGE_RELOC = 1
# the stages cfg.ablate may stub out
ABLATABLE = frozenset({"kf", "df"})


class VOState(NamedTuple):
    m: MapState
    pad: PaddedPyramid          # last frame's padded pyramid
    R: torch.Tensor             # (3, 3) T_f_w of the last frame
    t: torch.Tensor             # (3,)
    frame_id: torch.Tensor      # int32
    feat_px: torch.Tensor       # (F, 2)
    feat_f: torch.Tensor        # (F, 3)
    feat_level: torch.Tensor    # (F,) int32
    feat_point: torch.Tensor    # (F,) int32
    feat_valid: torch.Tensor    # (F,) bool
    stage: torch.Tensor         # int32 STAGE_*
    num_obs_last: torch.Tensor  # int32
    scrub_pending: torch.Tensor  # bool


class StepOut(NamedTuple):
    n_matches: torch.Tensor
    n_edges: torch.Tensor
    is_keyframe: torch.Tensor
    failed: torch.Tensor
    stage: torch.Tensor
    t_wc: torch.Tensor          # (3,) camera position in world
    R_fw: torch.Tensor          # (3, 3) rotation of T_f_w


def frame_feature_cap(n_cells: int, max_fts: int) -> int:
    """Slots of the per-frame feature table: the max_fts budget rounded up
    to 128, at most the cell count rounded up to 8."""
    return min(-(-n_cells // 8) * 8, -(-max_fts // 128) * 128)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index, without reading it to the host."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def _structure_opt_fused(m: MapState, T: SE3, frame_id: torch.Tensor,
                         feat_point: torch.Tensor, feat_valid: torch.Tensor,
                         n_opt: int, n_iter: int,
                         enabled: torch.Tensor) -> MapState:
    """optimizeStructure (frame_handler_base.cpp:178-196) with an enable
    mask: refine the n_opt longest-unoptimized points of this frame."""
    pt = m.pt
    P = pt.pos.shape[0]
    K = m.kf.R.shape[0]
    ok = feat_valid & (feat_point >= 0) & enabled
    pid_safe = torch.clamp(feat_point, 0, P - 1).to(torch.int64)
    age = torch.where(ok, pt.last_optim[pid_safe],
                      torch.full_like(feat_point, torch.iinfo(torch.int32).max))
    # lax.top_k(-age) order: oldest first, lower index first among ties
    order = torch.sort(age, stable=True)[1][:n_opt]
    sel = pid_safe[order]
    sel_ok = ok[order]
    kfs = torch.clamp(pt.obs_kf[sel], 0, K - 1).to(torch.int64)
    fts = torch.clamp(pt.obs_feat[sel], 0, m.kf.feat_f.shape[1] - 1) \
        .to(torch.int64)
    okf = torch.clamp(pt.orig_kf[sel], 0, K - 1).to(torch.int64)
    obs_R = torch.cat([m.kf.R[kfs], m.kf.R[okf][:, None]], dim=1)
    obs_t = torch.cat([m.kf.t[kfs], m.kf.t[okf][:, None]], dim=1)
    obs_f = torch.cat([m.kf.feat_f[kfs, fts], pt.orig_f[sel][:, None]], dim=1)
    obs_ok = torch.cat([pt.obs_valid[sel], (pt.orig_kf[sel] >= 0)[:, None]],
                       dim=1)
    can = sel_ok & (torch.sum(obs_ok, 1) >= 2)
    p_new, _ = optimize_points(pt.pos[sel], obs_R, obs_t, obs_f, obs_ok, can,
                               n_iter=n_iter)
    # only the refined rows are written: a padded row (clipped to point 0)
    # must not overwrite a real selection of point 0
    pos = svomap.set_rows(pt.pos, sel, p_new, can)
    last = svomap.set_rows(pt.last_optim, sel,
                           frame_id.expand(sel.shape[0]), can)
    return m._replace(pt=pt._replace(pos=pos, last_optim=last))


def _keyframe_stages(m: MapState, pad, T_out: SE3, frame_id, rep, feat_f,
                     feat_point, feat_valid, is_kf, depth_mean, depth_min,
                     cam, cfg: Config, ncx: int, ncy: int) -> MapState:
    """Keyframe insertion with creation-time feature tiles, observation
    binding and candidate promotion, local BA (loba_num_iter > 0), seed
    detection in the unoccupied cells and seed init, and the map cap.
    Each stage runs every frame; with ``is_kf`` False all of them leave
    the map as it was."""
    F = feat_point.shape[0]
    C = ncx * ncy
    P = m.pt.pos.shape[0]
    dev = feat_point.device
    pid = torch.clamp(rep.feat_point, 0, P - 1).to(torch.int64)
    kf_depth = torch.linalg.vector_norm(T_out.apply(m.pt.pos[pid]), dim=-1)
    ftile, fxy0 = extract_tiles(pad, rep.feat_px, rep.feat_level)
    # the F-slot frame table padded to the keyframe row capacity (C slots)
    m, slot = svomap.add_keyframe(
        m, pad.stack, T_out, frame_id, svomap.pad_rows(rep.feat_px, C, 0),
        svomap.pad_rows(feat_f, C, 0), svomap.pad_rows(rep.feat_level, C, 0),
        svomap.pad_rows(feat_point, C, -1), svomap.pad_rows(feat_valid, C, False),
        svomap.pad_rows(kf_depth, C, 1.0), feat_type=svomap.pad_rows(rep.feat_type, C, 0),
        feat_grad=svomap.pad_rows(rep.feat_grad, C, 0),
        feat_tile=svomap.pad_rows(ftile, C, 0),
        feat_tile_xy0=svomap.pad_rows(fxy0, C, -1), enable=is_kf)

    # observation binding; bound candidates become UNKNOWN
    bind = feat_valid & (feat_point >= 0) & is_kf
    pt = svomap.add_point_observations(
        m.pt, feat_point, slot.expand(F),
        torch.arange(F, dtype=torch.int32, device=dev), bind)
    hit = svomap.set_rows(torch.zeros((P,), dtype=torch.bool, device=dev),
                          pid, bind, bind)
    ptype = torch.where(hit & (pt.ptype == svomap.TYPE_CANDIDATE),
                        torch.full_like(pt.ptype, svomap.TYPE_UNKNOWN),
                        pt.ptype)
    m = m._replace(pt=pt._replace(ptype=ptype))

    if cfg.loba_num_iter > 0:
        mb = run_local_ba(m, torch.clamp(slot, min=0),
                          cfg.loba_robust_huber_width, cfg.loba_thresh,
                          cam.fx, n_iter=cfg.loba_num_iter,
                          core_n_kfs=cfg.core_n_kfs)
        keep = lambda a, b: torch.where(is_kf, a, b)  # noqa: E731
        m = m._replace(
            kf=m.kf._replace(R=keep(mb.kf.R, m.kf.R), t=keep(mb.kf.t, m.kf.t)),
            pt=m.pt._replace(pos=keep(mb.pt.pos, m.pt.pos),
                             ptype=keep(mb.pt.ptype, m.pt.ptype),
                             obs_valid=keep(mb.pt.obs_valid,
                                            m.pt.obs_valid)))

    # seeds in the cells this frame's features leave free, compacted to
    # the per-keyframe budget before their tiles are cut
    cells = cell_index(rep.feat_px, cfg.grid_size, ncx, ncy)
    occupied = torch.zeros((C,), dtype=torch.int32, device=dev).scatter_reduce(
        0, cells.to(torch.int64), feat_valid.to(torch.int32), reduce="amax",
        include_self=True) > 0
    det = detect_features(pad.levels()[:cfg.n_pyr_levels], occupied,
                          cfg.grid_size)
    good = det["valid"] & (det["score"] > cfg.triang_min_corner_score)
    sel, ok = svomap.mask_compact(good, min(C, cfg.max_seeds_per_kf))
    dpx, dlevel = det["px"][sel], det["level"][sel]
    dtile, dxy0 = extract_tiles(pad, dpx, dlevel)
    m = df.init_seeds_from_detection(
        m, slot, {"px": dpx, "score": det["score"][sel], "level": dlevel,
                  "valid": ok, "tile": dtile, "tile_xy0": dxy0},
        cam, depth_mean, 0.5 * depth_min,
        min_score=cfg.triang_min_corner_score, enable=is_kf)

    # map cap: drop the furthest keyframe, never the one just added
    if cfg.max_n_kfs > 2:
        over = svomap.n_active_kfs(m) > cfg.max_n_kfs
        far = svomap.furthest_kf(m.kf, T_out.inverse().t)
        drop = torch.where(is_kf & over & (far != slot), far,
                           torch.full_like(far, -1))
        m = svomap.delete_keyframe(m, drop)
    return m


def vo_step(state: VOState, img: torch.Tensor, cam, cfg: Config,
            ncx: int, ncy: int,
            img_shape: Tuple[int, int]) -> Tuple[VOState, StepOut]:
    """One tracking and mapping step (DEFAULT or RELOCALIZING stage) on the
    state's device; returns (new state, outputs).  Reads nothing back to
    the host."""
    abl = frozenset(cfg.ablate)
    if abl - ABLATABLE:
        raise NotImplementedError(
            f"only {sorted(ABLATABLE)} may be ablated, not "
            f"{sorted(abl - ABLATABLE)}")
    dev = state.R.device
    C = ncx * ncy
    F = frame_feature_cap(C, cfg.max_fts)
    shapes = pyramid_shapes(img_shape, cfg.n_levels_total)
    pad = build_padded_pyramid(img.to(dev), cfg.n_levels_total)
    m = state.m
    P = m.pt.pos.shape[0]

    # --- alignment reference: the last frame, or the closest keyframe when
    # relocalizing (frame_handler_mono.cpp:237-265); both computed, one kept
    reloc = state.stage == STAGE_RELOC
    kf_slot = torch.clamp(
        svomap.closest_kf(m.kf, SE3(state.R, state.t).inverse().t), min=0)
    kf_fv = _take(m.kf.feat_valid, kf_slot)
    kf_fp = _take(m.kf.feat_point, kf_slot)
    sel, sv = svomap.mask_compact(kf_fv & (kf_fp >= 0), F)
    rl = reloc.reshape(1)
    ref_R = torch.where(reloc, _take(m.kf.R, kf_slot), state.R)
    ref_t = torch.where(reloc, _take(m.kf.t, kf_slot), state.t)
    ref_px = torch.where(rl[:, None], _take(m.kf.feat_px, kf_slot)[sel],
                         state.feat_px)
    ref_f = torch.where(rl[:, None], _take(m.kf.feat_f, kf_slot)[sel],
                        state.feat_f)
    ref_pid = torch.where(rl, kf_fp[sel], state.feat_point)
    ref_ok = torch.where(rl, sv, state.feat_valid & (state.feat_point >= 0))
    ref_stack = torch.where(reloc, _take(m.kf.flat_pyr, kf_slot),
                            state.pad.stack)
    ref_pad = PaddedPyramid.from_stack(ref_stack, shapes)
    T_ref = SE3(ref_R, ref_t)
    pid_safe = torch.clamp(ref_pid, 0, P - 1).to(torch.int64)
    depth = torch.linalg.vector_norm(T_ref.apply(m.pt.pos[pid_safe]), dim=-1)
    ref_ok = ref_ok & (m.pt.ptype[pid_safe] != svomap.TYPE_DELETED)

    # --- 2. sparse image alignment
    ident = SE3.identity(device=dev)
    align = sparse_img_align(
        ref_pad, pad, cam, ident, ref_px, ref_f, depth, ref_ok,
        max_level=cfg.klt_max_level, min_level=cfg.klt_min_level,
        n_iter=cfg.img_align_n_iter, eps=cfg.img_align_eps,
        robust=cfg.img_align_robust)
    T_cur = align.T_cur_ref * T_ref
    reloc_fail = reloc & (align.n_tracked <= 30)

    # --- 3. reprojection + matching
    ptype_before = m.pt.ptype
    pt2, rep = reproject_map(m, T_cur, cam, cfg.grid_size, ncx, ncy,
                             max_level=cfg.n_pyr_levels - 1, cur_pad=pad,
                             max_fts=F,
                             attempt_factor=cfg.reproj_attempt_factor)
    m = m._replace(pt=pt2)
    # scrub after any deletion since the last scrub (core/map.py invariant)
    need_scrub = state.scrub_pending | torch.any(pt2.ptype != ptype_before)
    ms = svomap.scrub_dead_references(m)
    m = m._replace(
        kf=m.kf._replace(
            feat_valid=torch.where(need_scrub, ms.kf.feat_valid,
                                   m.kf.feat_valid),
            feat_point=torch.where(need_scrub, ms.kf.feat_point,
                                   m.kf.feat_point)),
        pt=m.pt._replace(obs_valid=torch.where(need_scrub, ms.pt.obs_valid,
                                               m.pt.obs_valid)))
    enough = rep.n_matches >= cfg.quality_min_fts

    # --- 4. pose optimization
    feat_f = cam.cam2world(rep.feat_px)
    pid = torch.clamp(rep.feat_point, 0, P - 1).to(torch.int64)
    pres = optimize_pose(T_cur, m.pt.pos[pid], feat_f, rep.feat_level,
                         rep.feat_valid & enough, cam.fx,
                         reproj_thresh=cfg.poseoptim_thresh,
                         n_iter=cfg.poseoptim_num_iter)

    # --- 6. quality gates (frame_handler_base.cpp:157-171)
    enough_edges = pres.n_obs >= 20
    insufficient = pres.n_obs < cfg.quality_min_fts
    dropped = (state.num_obs_last - pres.n_obs) > cfg.quality_max_drop_fts
    failed = reloc_fail | ~enough | ~enough_edges | insufficient
    T_out = SE3(state.R, state.t).where(failed, pres.T_f_w)
    feat_valid = pres.inliers & ~failed
    frame_id = state.frame_id + 1
    feat_point = torch.where(feat_valid, rep.feat_point,
                             torch.full_like(rep.feat_point, -1))

    # --- 5. structure optimization (masked off on failure)
    m = _structure_opt_fused(m, T_out, frame_id, feat_point, feat_valid,
                             cfg.structureoptim_max_pts,
                             cfg.structureoptim_num_iter, ~failed)

    # --- scene depth and the keyframe policy (frame_handler_mono.cpp:
    # 183-197: no overlapping keyframe within kfselect_mindist)
    if "kf" in abl:
        is_kf = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        depth_mean, depth_min = scene_depth(T_out, feat_point, feat_valid,
                                            m.pt.pos)
        overlap = svomap.overlapping_kfs(m.kf, T_out, cam)
        relpos = torch.abs(T_out.apply(svomap.kf_positions(m.kf))) \
            / depth_mean
        near = (relpos[:, 0] < cfg.kfselect_mindist) \
            & (relpos[:, 1] < cfg.kfselect_mindist * 0.8) \
            & (relpos[:, 2] < cfg.kfselect_mindist * 1.3)
        is_kf = ~failed & ~torch.any(overlap & near) & ~dropped

    # --- 7. depth filter: every df_update_every-th frame and on keyframes
    # (the reference's mapping-queue drops, depth_filter.cpp:82-97), when
    # some seed has work; a masked update is an exact no-op
    if "df" not in abl:
        due = is_kf
        if cfg.df_update_every > 1:
            due = due | ((frame_id % cfg.df_update_every) == 0)
        else:
            due = torch.ones_like(is_kf)
        due_work = due & df.has_update_work(m, T_out, cam,
                                            max_n_kfs=cfg.df_max_kf_age)
        upd = df.update_seeds_fields(
            m, pad, T_out, cam, max_n_kfs=cfg.df_max_kf_age,
            conv_thresh=cfg.seed_convergence_sigma2_thresh,
            max_steps=cfg.epi_max_steps, update_k=cfg.df_update_k,
            enable=due_work, short_steps=cfg.epi_short_steps,
            long_k=cfg.epi_long_k, max_level=cfg.n_pyr_levels - 1,
            scan_rows=cfg.epi_scan_rows)
        m = df.apply_seed_update(m, upd)

    # --- 8. keyframe insertion, binding, local BA, seeds, map cap; every
    # write is masked with is_kf
    if "kf" not in abl:
        m = _keyframe_stages(m, pad, T_out, frame_id, rep, feat_f, feat_point,
                             feat_valid, is_kf, depth_mean, depth_min, cam,
                             cfg, ncx, ncy)

    new_stage = torch.where(failed, STAGE_RELOC, STAGE_DEFAULT) \
        .to(torch.int32)
    num_obs = torch.where(failed, state.num_obs_last, pres.n_obs) \
        .to(torch.int32)
    new_state = VOState(
        m=m, pad=pad, R=T_out.R, t=T_out.t, frame_id=frame_id,
        feat_px=rep.feat_px, feat_f=feat_f, feat_level=rep.feat_level,
        feat_point=feat_point, feat_valid=feat_valid, stage=new_stage,
        num_obs_last=num_obs, scrub_pending=is_kf)
    out = StepOut(rep.n_matches, pres.n_obs, is_kf, failed, new_stage,
                  T_out.inverse().t, T_out.R)
    return new_state, out


def vo_scan(state: VOState, imgs, cam, cfg: Config, ncx: int, ncy: int,
            img_shape: Tuple[int, int]):
    """Track a sequence of images; returns (state, list of StepOut)."""
    outs = []
    for img in imgs:
        state, out = vo_step(state, img, cam, cfg, ncx, ncy, img_shape)
        outs.append(out)
    return state, outs


def seed_first_frame_with_depth(img: torch.Tensor, T_f_w: SE3,
                                depth_map: torch.Tensor, cam, cfg: Config,
                                img_shape: Tuple[int, int] = (480, 752),
                                device=None, frame_id: int = 0,
                                m: MapState | None = None) -> VOState:
    """Seed the map from a ground-truth depth map on the first frame
    (benchmark_node.cpp:216-234): detect corners, create GOOD points at
    the true depth, make the frame a keyframe, and seed the depth filter
    in the cells left without a point.  Into an empty map unless ``m`` (on
    the device) is given."""
    dev = resolve_device(device)
    img = img.to(dev)
    depth_map = depth_map.to(dev)
    T_f_w = SE3(T_f_w.R.to(dev), T_f_w.t.to(dev))
    n_levels = cfg.n_levels_total
    shapes = pyramid_shapes(img_shape, n_levels)
    Ws, Hs, _ = padded_layout(shapes)
    ncx, ncy = grid_dims(img_shape[1], img_shape[0], cfg.grid_size)
    C = ncx * ncy
    F = frame_feature_cap(C, cfg.max_fts)
    if m is None:
        m = svomap.init_map(cfg.max_kfs_pool, C, cfg.max_points,
                            cfg.max_obs_per_point, cfg.max_seeds, (Hs, Ws),
                            device=dev)
    pad = build_padded_pyramid(img, n_levels)
    det = detect_features(pad.levels()[:cfg.n_pyr_levels],
                          torch.zeros((C,), dtype=torch.bool, device=dev),
                          cfg.grid_size)
    px, level = det["px"], det["level"]
    f = cam.cam2world(px)
    xi = torch.clamp(px[:, 0].to(torch.int64), 0, img_shape[1] - 1)
    yi = torch.clamp(px[:, 1].to(torch.int64), 0, img_shape[0] - 1)
    d = depth_map[yi, xi]
    good = det["valid"] & torch.isfinite(d) & (d > 0)
    p_w = T_f_w.inverse().apply(f * d[:, None])

    tile, txy0 = extract_tiles(pad, px, level)
    frame_id = torch.tensor(frame_id, dtype=torch.int32, device=dev)
    no_pt = torch.full((C,), -1, dtype=torch.int32, device=dev)
    m, slot = svomap.add_keyframe(m, pad.stack, T_f_w, frame_id, px, f,
                                  level, no_pt, good, d, feat_tile=tile,
                                  feat_tile_xy0=txy0)
    slots = slot.expand(C)
    pt, ids = svomap.alloc_points(m.pt, p_w, svomap.TYPE_GOOD, slots, px, f,
                                  level, good, orig_tile=tile,
                                  orig_tile_xy0=txy0)
    pt = svomap.add_point_observations(
        pt, ids, slots, torch.arange(C, dtype=torch.int32, device=dev), good)
    kf_fp = svomap.set_rows(m.kf.feat_point, slot.reshape(1),
                            torch.where(good, ids, no_pt)[None],
                            (slot >= 0).reshape(1))
    m = m._replace(pt=pt, kf=m.kf._replace(feat_point=kf_fp))

    # frame table: up to F detections in the fixed shuffled cell order
    from rpg_svo_tpu_torch.core.reprojector import _cell_perm
    perm = _cell_perm(C, str(dev))
    sel_p, sv = svomap.mask_compact(good[perm], F)
    sel = perm[sel_p]
    feat_point = torch.where(sv, ids[sel], torch.full_like(ids[sel], -1))
    # depth-filter seeds in the cells without a feature
    depth_mean, depth_min = scene_depth(T_f_w, feat_point, sv, m.pt.pos)
    m = df.init_seeds(m, slot, pad, cam, good, depth_mean, 0.5 * depth_min,
                      cell_size=cfg.grid_size,
                      min_score=cfg.triang_min_corner_score,
                      det_levels=cfg.n_pyr_levels,
                      max_per_kf=cfg.max_seeds_per_kf)
    return VOState(
        m=m, pad=pad, R=T_f_w.R.clone(), t=T_f_w.t.clone(),
        frame_id=frame_id, feat_px=px[sel], feat_f=f[sel],
        feat_level=level[sel], feat_point=feat_point, feat_valid=sv,
        stage=torch.full((), STAGE_DEFAULT, dtype=torch.int32, device=dev),
        num_obs_last=torch.sum(good).to(torch.int32),
        scrub_pending=torch.ones((), dtype=torch.bool, device=dev))


def state_from_handler(fh) -> VOState:
    """The step's state from a host ``FrameHandler`` after its start (the
    ``bench.py --bootstrap`` protocol: bootstrap with the handler, track
    with ``vo_step``)."""
    lf = fh.last_frame
    dev = lf.R.device
    return VOState(
        m=fh.map, pad=lf.pad, R=lf.R, t=lf.t, frame_id=lf.frame_id,
        feat_px=lf.feat_px, feat_f=lf.feat_f, feat_level=lf.feat_level,
        feat_point=lf.feat_point, feat_valid=lf.feat_valid,
        stage=torch.full((), STAGE_DEFAULT, dtype=torch.int32, device=dev),
        num_obs_last=torch.tensor(fh.num_obs_last, dtype=torch.int32,
                                  device=dev),
        scrub_pending=torch.ones((), dtype=torch.bool, device=dev))
