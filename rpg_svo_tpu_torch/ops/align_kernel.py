"""Sparse image alignment in one launch (CUDA kernel K2).

Port of ``rpg_svo_tpu/ops/pallas_align.py``.  The TPU kernel runs the
Gauss-Newton loop of one pyramid level on tiles gathered beforehand; its
Hopper redesign ``sparse_align_kernel`` (``csrc/sparse_align.cu``) runs the
whole coarse-to-fine alignment, reference patches, Jacobians and window
reads included, in one launch for CUDA tensors.  Its plain twin is
``sparse_align.sparse_img_align_plain``; ``level_tiles`` is the plain
path's tile gather around each feature's initial projection.

Under ``torch.func.vmap`` (a batch of camera streams, parallel/streams.py)
the launcher calls the custom op ``svo_torch::sparse_align``, whose vmap
rule aligns every stream in one launch of K2 with one block per stream;
on the CPU the op runs the plain twin stream by stream.
"""

from __future__ import annotations

import ctypes

import torch

from rpg_svo_tpu_torch import is_batched
from rpg_svo_tpu_torch.core import graphed
from rpg_svo_tpu_torch.geometry.cameras import (
    PinholeCamera, PinholeCameraIdeal)
from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.ops import cuda_build
from rpg_svo_tpu_torch.ops.tiles import (
    MAX_LEVELS, LevelTable, _kernel_table, _shapes_arg, _shapes_of,
    _stream_major, gather_tiles, padded_layout)

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


class _StreamStrides(ctypes.Structure):
    """``StreamStrides`` of ``csrc/sparse_align.cu``, passed by value."""
    _fields_ = [(k, ctypes.c_longlong) for k in
                ("ref", "cur", "px", "f", "depth", "valid", "R", "t")]


def _cam_list(cam: PinholeCamera) -> list:
    """The camera as the op's float list: its fields, then 1.0 for a
    PinholeCameraIdeal."""
    return [float(v) for v in cam] \
        + [float(isinstance(cam, PinholeCameraIdeal))]


def _cam_of(vals) -> PinholeCamera:
    cls = PinholeCameraIdeal if vals[-1] else PinholeCamera
    return cls(*[float(v) for v in vals[:-1]])


_K2_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, LevelTable,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, _Cam,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)


class _SparseAlign:
    """K2 launcher; ``launches`` counts the kernel launches it makes.  A
    call recorded into a CUDA graph launches nothing: it is handed to
    ``core/graphed.record_launch``, and the graph's replays count it."""

    def __init__(self):
        self.launches = 0

    def __call__(self, ref_pad, cur_pad, cam, T_init: SE3, feats_px,
                 feats_f, feats_depth, feats_valid, max_level: int,
                 min_level: int, n_iter: int, eps: float):
        """(T_cur_ref, n_tracked int32, H (6, 6), chi2, iterations run at
        each level (MAX_LEVELS,) int32) of the whole alignment; all views
        of the kernel's (64,) float32 output row.  A feature count whose
        per-feature state does not fit in one block's shared memory is
        refused by the kernel's entry point.  A stream batch under vmap
        goes through ``sparse_align_op``: one launch for every stream."""
        ref, cur = ref_pad.stack, cur_pad.stack
        if ref_pad.shapes != cur_pad.shapes:
            raise ValueError("reference and current pyramids differ in "
                             "layout")
        if is_batched(ref, cur, T_init.R, T_init.t, feats_px, feats_f,
                      feats_depth, feats_valid):
            return _unpack(*sparse_align_op(
                ref, cur, T_init.R, T_init.t, feats_px, feats_f,
                feats_depth, feats_valid, _cam_list(cam),
                _shapes_arg(cur_pad.shapes), int(max_level), int(min_level),
                int(n_iter), float(eps)))
        if not cur.is_cuda:
            raise ValueError("sparse_align kernel needs CUDA tensors")
        dev = cur.device
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
        if torch.cuda.is_current_stream_capturing():
            graphed.record_launch("sparse_align")
        else:
            self.launches += 1
        return _unpack(out)

    def batched(self, ref, cur, shapes, cam, R0, t0, px, f, depth, valid,
                max_level: int, min_level: int, n_iter: int,
                eps: float) -> torch.Tensor:
        """B streams in one launch, one block each: stacks (B, Hs, Ws),
        px (B, N, 2), f (B, N, 3), depth and valid (B, N), R0 (B, 3, 3),
        t0 (B, 3), each stream's slab contiguous (stream stride 0 for a
        shared input).  Returns the (B, OUT_LEN) output rows as two
        tensors: the float slots, and the int32 slots at the same
        offsets."""
        if not cur.is_cuda:
            raise ValueError("sparse_align kernel needs CUDA tensors")
        dev = cur.device
        Ws, Hs, _ = padded_layout(shapes)
        if not 0 <= min_level <= max_level < min(len(shapes), MAX_LEVELS):
            raise ValueError(f"levels {max_level}..{min_level} outside the "
                             f"pyramid's {len(shapes)}")
        B, N = int(cur.shape[0]), int(px.shape[1])
        want = {"ref stack": (ref, torch.float32, (Hs, Ws)),
                "cur stack": (cur, torch.float32, (Hs, Ws)),
                "feats_px": (px, torch.float32, (N, 2)),
                "feats_f": (f, torch.float32, (N, 3)),
                "feats_depth": (depth, torch.float32, (N,)),
                "feats_valid": (valid, torch.bool, (N,)),
                "T_init.R": (R0, torch.float32, (3, 3)),
                "T_init.t": (t0, torch.float32, (3,))}
        for name, (a, dt, shape) in want.items():
            if a.device != dev or a.dtype != dt \
                    or tuple(a.shape) != (B,) + shape \
                    or not a[0].is_contiguous():
                raise ValueError(f"{name}: want {dt} {(B,) + shape} with "
                                 f"contiguous streams on {dev}, got "
                                 f"{a.dtype} {tuple(a.shape)} strides "
                                 f"{a.stride()} on {a.device}")
        out = torch.empty((B, OUT_LEN), dtype=torch.float32, device=dev)
        outi = torch.empty((B, OUT_LEN), dtype=torch.int32, device=dev)
        ss = _StreamStrides(ref.stride(0), cur.stride(0), px.stride(0),
                            f.stride(0), depth.stride(0), valid.stride(0),
                            R0.stride(0), t0.stride(0))
        fn = cuda_build.function("sparse_align_batched", _K2B_ARGTYPES,
                                 library="sparse_align")
        err = fn(ref.data_ptr(), cur.data_ptr(), Ws, _kernel_table(shapes),
                 px.data_ptr(), f.data_ptr(), depth.data_ptr(),
                 valid.data_ptr(), R0.data_ptr(), t0.data_ptr(),
                 _cam_struct(cam), int(max_level), int(min_level),
                 int(n_iter), float(eps), N, out.data_ptr(), outi.data_ptr(),
                 ss, B, cuda_build.raw_stream(dev))
        cuda_build.check(err, "sparse_align_batched")
        if torch.cuda.is_current_stream_capturing():
            graphed.record_launch("sparse_align")
        else:
            self.launches += 1
        return out, outi


def _unpack(out: torch.Tensor, ints: torch.Tensor = None):
    """(T, n_tracked, H, chi2, iterations per level) from an output row
    (its int32 slots in ``ints`` when they come apart from it)."""
    if ints is None:
        ints = out.view(torch.int32)
    return (SE3(out[:9].reshape(3, 3), out[9:12]), ints[OUT_TRACKED],
            out[12:48].reshape(6, 6), out[48],
            ints[OUT_ITERS:OUT_ITERS + MAX_LEVELS])


sparse_align_kernel = _SparseAlign()

_K2B_ARGTYPES = _K2_ARGTYPES[:-1] + (ctypes.c_void_p, _StreamStrides,
                                     ctypes.c_int, ctypes.c_void_p)


@torch.library.custom_op(
    "svo_torch::sparse_align", mutates_args=(),
    schema="(Tensor ref, Tensor cur, Tensor R0, Tensor t0, Tensor px, "
           "Tensor f, Tensor depth, Tensor valid, float[] cam, int[] shapes, "
           "int max_level, int min_level, int n_iter, float eps) "
           "-> (Tensor, Tensor)")
def sparse_align_op(ref, cur, R0, t0, px, f, depth, valid, cam, shapes,
                    max_level, min_level, n_iter, eps):
    """The whole alignment for a stream batch (leading axis B on every
    tensor): the (B, OUT_LEN) output rows as their float slots and their
    int32 slots (an op may not return two views of one tensor, and vmap
    has no rule for a dtype view in every torch); one launch of K2 on the
    card, the plain twin stream by stream on the CPU.  The launcher
    reaches it under vmap, through the rule below."""
    shp = _shapes_of(shapes)
    camera = _cam_of(cam)
    if cur.is_cuda:
        return sparse_align_kernel.batched(
            ref, cur, shp, camera, R0, t0, px, f, depth, valid, max_level,
            min_level, n_iter, eps)
    from rpg_svo_tpu_torch.ops.sparse_align import sparse_img_align_plain
    from rpg_svo_tpu_torch.ops.tiles import PaddedPyramid
    rows, irows = [], []
    for b in range(cur.shape[0]):
        r = sparse_img_align_plain(
            PaddedPyramid(ref[b], shp), PaddedPyramid(cur[b], shp), camera,
            SE3(R0[b], t0[b]), px[b], f[b], depth[b], valid[b], max_level,
            min_level, n_iter, eps)
        row = torch.zeros((OUT_LEN,), dtype=torch.float32)
        ints = torch.zeros((OUT_LEN,), dtype=torch.int32)
        row[:9] = r.T_cur_ref.R.reshape(-1)
        row[9:12] = r.T_cur_ref.t
        row[12:48] = r.H.reshape(-1)
        row[48] = r.chi2
        row[49] = r.n_tracked * 16
        ints[OUT_TRACKED] = r.n_tracked
        ints[OUT_ITERS:OUT_ITERS + MAX_LEVELS] = r.iters
        rows.append(row)
        irows.append(ints)
    return torch.stack(rows), torch.stack(irows)


def _sparse_align_vmap(info, in_dims, *args):
    tensors = _stream_major(info, in_dims[:8], *args[:8])
    if tensors[1].dim() != 3:
        raise NotImplementedError("sparse_align batches one stream axis")
    return sparse_align_op(*tensors, *args[8:]), (0, 0)


torch.library.register_vmap("svo_torch::sparse_align", _sparse_align_vmap)


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
