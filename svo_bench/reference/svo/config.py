"""Pipeline configuration (a copy of ``rpg_svo_tpu/config.py``).

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_fused.py`` holds its fields and defaults equal to the
original.  Frozen dataclass passed explicitly through the pipeline; the
parameter names and defaults mirror the reference SVO ``Config``
(``svo/include/svo/config.h:31-155``) and the paper's presets (Table I).
Static capacities (features per frame, seeds, keyframes, points) size the
fixed-capacity pools of ``core/map.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Config:
    # --- tracing ---
    trace_name: str = "svo"
    trace_dir: str = "/tmp"

    # --- pyramid / detection ---
    # Detection / matching pyramid depth (ref default 3, config.cpp:28):
    # FAST corners and depth-filter seeds live on levels [0, n_pyr_levels);
    # the matcher's best_search_level is capped at n_pyr_levels-1
    # (matcher.cpp:152,214).  The pyramid itself is built
    # max(n_pyr_levels, klt_max_level+1) = 5 levels deep for the
    # coarse-to-fine alignment (frame.cpp:58) — see n_levels_total.
    n_pyr_levels: int = 3
    grid_size: int = 25             # detector/reprojector cell size in px
    triang_min_corner_score: float = 20.0  # min Shi-Tomasi score for a new seed

    # --- sparse image alignment ---
    klt_max_level: int = 4          # coarsest pyramid level for image alignment
    klt_min_level: int = 2          # finest pyramid level for image alignment
    img_align_n_iter: int = 30      # GN iterations per level
    img_align_eps: float = 1e-7     # convergence threshold on |dx|
    # optional Tukey/MAD robust weighting of the photometric residuals
    # (the reference's vk::NLLSSolver weight-function hook — default-off
    # there as well, sparse_img_align.cpp:82-83)
    img_align_robust: bool = False
    # GN loop structure on TPU: `unroll` masked iterations per while_loop
    # step; >= n_iter drops the while entirely (straight-line, masked)
    img_align_unroll: int = 3

    # --- two-view initialization ---
    init_min_disparity: float = 50.0
    init_min_tracked: int = 50
    init_min_inliers: int = 40
    map_scale: float = 1.0

    # --- reprojection / matching ---
    max_fts: int = 120              # per-frame feature budget
    reproj_thresh: float = 2.0      # px; outlier threshold after pose opt
    # Static cell-attempt budget = max(factor*max_fts, 256) cells (the
    # reference attempts until maxFts MATCHES, reprojector.cpp:195-201;
    # 2.0 covers a 50% failure rate, steady-state success is ~90%)
    reproj_attempt_factor: float = 2.0
    subpix_n_iter: int = 10         # feature-alignment iterations

    # --- pose / structure optimization ---
    poseoptim_thresh: float = 2.0   # px
    poseoptim_num_iter: int = 10
    structureoptim_max_pts: int = 20
    structureoptim_num_iter: int = 5

    # --- local bundle adjustment ---
    core_n_kfs: int = 3
    loba_thresh: float = 2.0
    loba_robust_huber_width: float = 1.0
    loba_num_iter: int = 0          # 0 disables local BA (fast preset)

    # --- keyframe / map policy ---
    kfselect_mindist: float = 0.12  # rel. translation / scene depth for new KF
    max_n_kfs: int = 10             # 0 = unlimited ("SLAM mode" per reference)

    # --- quality gates ---
    quality_min_fts: int = 50
    quality_max_drop_fts: int = 40

    # --- depth filter ---
    seed_convergence_sigma2_thresh: float = 200.0  # converge when sqrt(s2) < range/this
    df_max_kf_age: int = 3          # seeds older than this many KFs are dropped
    # Static cap on epipolar scan steps.  The reference caps at 1000 evals of
    # ~0.7px (matcher.cpp:251-256); our strip scan instead BUMPS the search
    # level until the whole segment fits in max_steps 1-px samples, so a much
    # smaller cap covers the same range (coarser scan + subpixel refinement).
    epi_max_steps: int = 128
    # Seeds updated per frame: eligible seeds are compacted to this many
    # before the epipolar search, so its cost scales with live seeds, not
    # with the pool capacity.
    df_update_k: int = 512
    # Two-tier scan (0 disables): seeds whose epipolar segment fits in
    # `epi_short_steps` 1-px windows scan a short strip in place; longer
    # segments are compacted to `epi_long_k` slots and scan at
    # epi_max_steps width (overflow longs are deferred to a later frame).
    # The strip gather is latency-bound per SAMPLE, so total samples —
    # K*(short+8)*8 + long_k*(max+8)*8 — is the whole scan cost.
    epi_short_steps: int = 0
    epi_long_k: int = 192
    # Rows of the scan strip sampled along the patch normal (of PATCH=8).
    # The strip gather is per-sample latency-bound (~7 ns/sample measured
    # — the single largest cost of the fused step), so 4 halves the
    # epipolar scan cost; the full 8x8 align2d refinement and the ZMSSD
    # normalization/threshold adapt (ops/matcher._strip_scan).
    epi_scan_rows: int = 8
    # Update seeds only every Nth non-keyframe frame (keyframes always
    # update).  The reference's mapping thread drops frames whenever its
    # queue (cap 3) is full (depth_filter.cpp:82-97); this is the static
    # equivalent.  1 = every frame.
    df_update_every: int = 1

    # --- static capacities (TPU additions; not in the reference) ---
    # New-seed budget per keyframe: detections are compacted to this many
    # rows BEFORE tile extraction and the (every-frame, masked) seed-init
    # scatters — the scatters' cost scales with rows, not detections.
    # The reference has no cap (one seed per unoccupied cell); 384 covers
    # the bench scenes' detection counts (multiple of 128 per the pool
    # layout rules).
    max_seeds_per_kf: int = 384
    max_seeds: int = 2048           # live depth-filter seeds (SoA pool)
    max_points: int = 8192          # map point pool
    max_kfs_pool: int = 64          # keyframe pool (>= max_n_kfs + margin)
    max_obs_per_point: int = 16     # observation slots per point
    patch_halfsize_align: int = 2   # 4x4 patch for sparse image alignment
    patch_halfsize_match: int = 4   # 8x8 patch for matching/feature alignment

    # --- misc ---
    use_imu: bool = False
    img_imu_delay: float = 0.0

    # --- mesh sharding ---
    # Name of the mesh axis over which the fused step's batched internals
    # (depth-filter K-domain epipolar match, local-BA point blocks) are
    # sharded, each rank taking its rows (parallel/gspmd.py).  "" = the
    # single-device step, no collective.  Set by parallel/fused_mesh.py,
    # which makes the mesh ambient around the step.
    shard_axis: str = ""

    # --- debug/measurement only ---
    # Stage names stubbed out of the fused step at trace time; used by
    # tools_stage_timing.py to attribute device time by differencing.
    # Must stay () in production (it changes results).
    ablate: tuple = ()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def n_levels_total(self) -> int:
        """Pyramid depth actually built (ref: max(n_pyr_levels, klt_max_level+1))."""
        return max(self.n_pyr_levels, self.klt_max_level + 1)


def fast_preset(**overrides) -> Config:
    """The paper's 'fast' preset (Table I; svo_ros/param/vo_fast.yaml)."""
    base = dict(max_fts=120, max_n_kfs=10, loba_num_iter=0, grid_size=30,
                df_update_every=2,
                # tight KF pool: pool rows are pyramid-sized, and pool
                # size directly scales map-update bandwidth
                max_kfs_pool=16,
                quality_min_fts=50,
                # two-tier epipolar scan ON (exact — tested identical to
                # the single-tier scan): most mature seeds scan a short
                # 16-step strip in place, long segments compact to 128
                # full-width slots.  Measured +35% fps on the TPU bench
                # at identical accuracy (178 -> 242 with epi_max_steps
                # 64; tools_batch_r2a/b logs).
                epi_short_steps=16,
                epi_long_k=128,
                # 4-row scan strips: identical golden-protocol accuracy
                # (p50 0.0716 vs 0.0714, conv 7512 vs 7519 on the flat
                # epipolar sweep) at half the scan gather cost
                epi_scan_rows=4)
    base.update(overrides)
    return Config(**base)


def accurate_preset(**overrides) -> Config:
    """The paper's 'accurate' preset (Table I; svo_ros/param/vo_accurate.yaml).

    df_update_every=2 like the fast preset: the reference's mapping
    thread consumes frames from a size-3 queue and DROPS the rest
    whenever the tracker outpaces it (depth_filter.cpp:82-97) — at
    ~500 fps it would drop most of them; every-2nd-frame is the static
    equivalent.  Measured on the TPU bench: 432.9 -> 492.6 fps at
    identical trajectory accuracy (1.90 mm median, r5)."""
    base = dict(max_fts=200, max_n_kfs=50, loba_num_iter=10, grid_size=20,
                core_n_kfs=5, quality_min_fts=50, max_points=16384,
                max_kfs_pool=64, df_update_every=2)
    base.update(overrides)
    return Config(**base)


def bench_cfg(preset: str) -> Config:
    """The settings of ``bench.py::make_cfg(preset)`` with no environment
    overrides: grid 25, epipolar scan 32/8 steps, 192 seed updates, 4 scan
    rows and a 1.5x reprojection attempt budget on top of the preset."""
    kw = dict(grid_size=25, epi_max_steps=32, epi_short_steps=8,
              df_update_k=192, epi_scan_rows=4, reproj_attempt_factor=1.5)
    if preset == "accurate":
        return accurate_preset(epi_long_k=128, **kw)
    if preset != "fast":
        raise ValueError(f"unknown preset {preset!r}")
    return fast_preset(**kw)
