"""Sparse image alignment in one launch (CUDA kernel K2).

Port of ``rpg_svo_tpu/ops/pallas_align.py``.  The TPU kernel runs the
Gauss-Newton loop of one pyramid level on tiles gathered beforehand; its
Hopper redesign ``sparse_align_kernel`` (``csrc/sparse_align.cu``) runs the
whole coarse-to-fine alignment, reference patches, Jacobians and window
reads included, in one launch for CUDA tensors.  Its plain twin is
``sparse_align.sparse_img_align_plain``; ``level_tiles`` is the plain
path's tile gather around each feature's initial projection.
"""

from __future__ import annotations

import ctypes

import torch

from rpg_svo_tpu_torch.geometry.cameras import (
    PinholeCamera, PinholeCameraIdeal)
from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.ops import cuda_build
from rpg_svo_tpu_torch.ops.tiles import MAX_LEVELS, LevelTable, gather_tiles

PATCH_HALFSIZE = 2
PATCH_SIZE = 4
SLACK = 6
TILE = PATCH_SIZE + 1 + 2 * SLACK   # 17

# the kernel's output row: float pose (12), H (36), chi2, n_meas; int32
# tracked features and iterations run at each level
OUT_LEN = 64
OUT_TRACKED = 50
OUT_ITERS = 56


def use_align_kernel(cam, cur_pad, robust: bool) -> bool:
    """K2 serves pinhole cameras with a padded current pyramid on the card
    and no robust weighting (the rule of ``sparse_align.py:311-330``)."""
    if robust or cur_pad is None or not isinstance(cam, PinholeCamera):
        return False
    return cur_pad.stack.is_cuda


class _Cam(ctypes.Structure):
    """``Cam`` of ``csrc/sparse_align.cu``, passed by value."""
    _fields_ = [(k, ctypes.c_float) for k in
                ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")] \
        + [("distort", ctypes.c_int)]


def _cam_struct(cam: PinholeCamera) -> _Cam:
    return _Cam(cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1,
                cam.p2, cam.k3, int(not isinstance(cam, PinholeCameraIdeal)))


_K2_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, LevelTable,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, _Cam,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)


class _SparseAlign:
    """K2 launcher; ``launches`` counts kernel launches (nothing else)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, ref_pad, cur_pad, cam, T_init: SE3, feats_px,
                 feats_f, feats_depth, feats_valid, max_level: int,
                 min_level: int, n_iter: int, eps: float):
        """(T_cur_ref, n_tracked int32, H (6, 6), chi2, iterations run at
        each level (MAX_LEVELS,) int32) of the whole alignment; all views
        of the kernel's (64,) float32 output row.  A feature count whose
        per-feature state does not fit in one block's shared memory is
        refused by the kernel's entry point."""
        ref, cur = ref_pad.stack, cur_pad.stack
        if not cur.is_cuda:
            raise ValueError("sparse_align kernel needs CUDA tensors")
        dev = cur.device
        if ref_pad.shapes != cur_pad.shapes:
            raise ValueError("reference and current pyramids differ in "
                             "layout")
        if not 0 <= min_level <= max_level < min(len(cur_pad.shapes),
                                                 MAX_LEVELS):
            raise ValueError(f"levels {max_level}..{min_level} outside the "
                             f"pyramid's {len(cur_pad.shapes)}")
        N = int(feats_px.shape[0])
        want = {"ref stack": (ref, torch.float32, tuple(cur.shape)),
                "cur stack": (cur, torch.float32, tuple(cur.shape)),
                "feats_px": (feats_px, torch.float32, (N, 2)),
                "feats_f": (feats_f, torch.float32, (N, 3)),
                "feats_depth": (feats_depth, torch.float32, (N,)),
                "feats_valid": (feats_valid, torch.bool, (N,)),
                "T_init.R": (T_init.R, torch.float32, (3, 3)),
                "T_init.t": (T_init.t, torch.float32, (3,))}
        for name, (a, dt, shape) in want.items():
            if a.device != dev or a.dtype != dt or tuple(a.shape) != shape \
                    or not a.is_contiguous():
                raise ValueError(f"{name}: want contiguous {dt} {shape} on "
                                 f"{dev}, got {a.dtype} {tuple(a.shape)} on "
                                 f"{a.device}")
        out = torch.empty((OUT_LEN,), dtype=torch.float32, device=dev)
        fn = cuda_build.function("sparse_align", _K2_ARGTYPES)
        err = fn(ref.data_ptr(), cur.data_ptr(), int(cur.shape[1]),
                 cur_pad.kernel_table(), feats_px.data_ptr(),
                 feats_f.data_ptr(), feats_depth.data_ptr(),
                 feats_valid.data_ptr(), T_init.R.data_ptr(),
                 T_init.t.data_ptr(), _cam_struct(cam), int(max_level),
                 int(min_level), int(n_iter), float(eps), N, out.data_ptr(),
                 cuda_build.raw_stream(dev))
        cuda_build.check(err, "sparse_align")
        self.launches += 1
        ints = out.view(torch.int32)
        return (SE3(out[:9].reshape(3, 3), out[9:12]), ints[OUT_TRACKED],
                out[12:48].reshape(6, 6), out[48],
                ints[OUT_ITERS:OUT_ITERS + MAX_LEVELS])


sparse_align_kernel = _SparseAlign()


def level_tiles(cur_pad, cam, T_init: SE3, p_ref: torch.Tensor, level: int,
                gather=gather_tiles):
    """Each feature's (TILE, TILE) tile around its initial projection at
    ``level``, with the clamped origins: (tiles, x0c, y0c); ``gather`` has
    ``gather_tiles``' signature."""
    scale = 1.0 / (2.0 ** level)
    uv0 = cam.world2cam(T_init.apply(p_ref)) * scale
    base = torch.floor(uv0).to(torch.int32) - PATCH_HALFSIZE - SLACK
    lv = torch.full((p_ref.shape[0],), level, dtype=torch.int32,
                    device=p_ref.device)
    return gather(cur_pad, lv, base[:, 0], base[:, 1], TILE, TILE)
