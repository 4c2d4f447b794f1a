"""The padded pyramid stack and the batched tile gather (CUDA kernel K1).

Port of ``rpg_svo_tpu/ops/pallas_tiles.py``.  All pyramid levels are padded
(H to 8 rows, W to 128 columns, at least 256) and stacked vertically into
one (Hs, Ws) float32 array with 40 rows of tail slack, exactly the JAX
layout: the keyframe pool stores these stacks, and the state converter
relies on equal shapes.

``gather_tiles`` clamps each requested origin into its level (so every tile
is fully backed by image content; callers read validity from the clamped
origins), offsets it by the level's first row, and copies the tiles.  For
a CUDA stack all of that is one launch of kernel K1
(``csrc/tile_gather.cu``); for a CPU stack it is the plain twin
``gather_tiles_plain`` (a torch clamp and a flat-index gather).

Under ``torch.func.vmap`` (a batch of camera streams, parallel/streams.py)
``gather_tiles`` calls the custom op ``svo_torch::tile_gather``, whose
vmap rule gathers every stream's tiles in one launch of K1 with a stream
grid axis (the JAX kernel gains a grid axis under ``jax.vmap``); on the
CPU the op runs the plain twin stream by stream.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch import is_batched
from rpg_svo_tpu_torch.core import graphed
from rpg_svo_tpu_torch.ops import cuda_build

TAIL_ROWS = 40
MAX_LEVELS = 8          # the kernels' level-table capacity


def padded_layout(shapes: Sequence[Tuple[int, int]]):
    """(Ws, Hs, row_off) of the padded stack for the given level shapes."""
    Ws = max(256, -(-max(w for _, w in shapes) // 128) * 128)
    offs = []
    row = 0
    for h, _ in shapes:
        offs.append(row)
        row += -(-h // 8) * 8
    return Ws, row + TAIL_ROWS, np.asarray(offs, dtype=np.int32)


# unbounded: a captured CUDA graph (core/graphed.py) reads the table at
# its address, so an evicted table would leave a graph reading freed
# memory; one (3, L) table per layout and device lives for the process
@functools.cache
def _level_table(shapes: Tuple[Tuple[int, int], ...], device: str):
    """(W, H, row_off) per level as int32 tensors on ``device``, made once
    per layout so the per-frame path never copies constants to the card."""
    _, _, offs = padded_layout(shapes)
    tab = np.stack([np.asarray([w for _, w in shapes], np.int32),
                    np.asarray([h for h, _ in shapes], np.int32), offs])
    return torch.from_numpy(tab).to(device)


class LevelTable(ctypes.Structure):
    """(W, H, first row) per level, passed by value to the kernels
    (``LevelTable`` in ``csrc/tile_gather.cu`` and ``csrc/sparse_align.cu``).
    """
    _fields_ = [("n", ctypes.c_int), ("w", ctypes.c_int * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("off", ctypes.c_int * MAX_LEVELS)]


@functools.lru_cache(maxsize=32)
def _kernel_table(shapes: Tuple[Tuple[int, int], ...]) -> LevelTable:
    if len(shapes) > MAX_LEVELS:
        raise ValueError(f"the kernels take at most {MAX_LEVELS} levels")
    _, _, offs = padded_layout(shapes)
    tab = LevelTable()
    tab.n = len(shapes)
    for l, ((h, w), o) in enumerate(zip(shapes, offs)):
        tab.w[l], tab.h[l], tab.off[l] = w, h, int(o)
    return tab


@dataclasses.dataclass(frozen=True)
class PaddedPyramid:
    """Pyramid levels padded and vertically stacked into one 2-D tensor.

    stack: (Hs, Ws) float32; level l occupies rows row_off[l] .. +Hp[l],
    with the real (h, w) content at the top left and zeros elsewhere."""
    stack: torch.Tensor
    shapes: Tuple[Tuple[int, int], ...]

    @property
    def Ws(self) -> int:
        return padded_layout(self.shapes)[0]

    @property
    def Hs(self) -> int:
        return padded_layout(self.shapes)[1]

    @property
    def row_off(self) -> np.ndarray:
        return padded_layout(self.shapes)[2]

    @classmethod
    def from_levels(cls, levels: Sequence[torch.Tensor]) -> "PaddedPyramid":
        shapes = tuple((int(l.shape[0]), int(l.shape[1])) for l in levels)
        Ws, Hs, offs = padded_layout(shapes)
        # each level zero-padded to its rows and the stack's width, then
        # the tail rows: built out of place, so that it batches under vmap
        rows = [F.pad(img.to(torch.float32),
                      (0, Ws - w, 0, -(-h // 8) * 8 - h))
                for (h, w), img in zip(shapes, levels)]
        rows.append(torch.zeros((TAIL_ROWS, Ws), dtype=torch.float32,
                                device=levels[0].device))
        return cls(torch.cat(rows), shapes)

    @classmethod
    def from_stack(cls, stack: torch.Tensor,
                   shapes: Sequence[Tuple[int, int]]) -> "PaddedPyramid":
        """Wrap an existing padded stack (no data movement)."""
        shapes = tuple((int(h), int(w)) for h, w in shapes)
        Ws, Hs, _ = padded_layout(shapes)
        return cls(stack.reshape(Hs, Ws), shapes)

    def levels(self) -> Tuple[torch.Tensor, ...]:
        """Per-level images as views of the stack."""
        return tuple(self.stack[int(o): int(o) + h, :w]
                     for o, (h, w) in zip(self.row_off, self.shapes))

    def flat_view(self):
        """Strided FlatPyramid over this stack (zero-copy)."""
        from rpg_svo_tpu_torch.ops.interp import FlatPyramid
        return FlatPyramid.from_padded(self)

    def level_table(self) -> torch.Tensor:
        """(3, L) int32 device table: widths, heights, first rows."""
        return _level_table(self.shapes, str(self.stack.device))

    def kernel_table(self) -> "LevelTable":
        """The same table as the kernels' by-value struct."""
        return _kernel_table(self.shapes)


# a pytree node, so that stacked states (parallel/streams.py) and vmap carry
# the stack as their leaf; the level shapes are static
pytree.register_pytree_node(
    PaddedPyramid, lambda p: ([p.stack], p.shapes),
    lambda leaves, shapes: PaddedPyramid(leaves[0], shapes),
    serialized_type_name="rpg_svo_tpu_torch.ops.tiles.PaddedPyramid")


_K1_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, LevelTable,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p)
_LL = ctypes.c_longlong
_K1B_ARGTYPES = (ctypes.c_void_p, _LL, ctypes.c_int, LevelTable,
                 ctypes.c_void_p, _LL, _LL, ctypes.c_void_p, _LL, _LL,
                 ctypes.c_void_p, _LL, _LL, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p)


class _TileGather:
    """K1 launcher; ``launches`` counts the kernel launches it makes.  A
    call recorded into a CUDA graph launches nothing: it is handed to
    ``core/graphed.record_launch``, and the graph's replays count it."""

    def __init__(self):
        self.launches = 0

    def __call__(self, pyr: PaddedPyramid, level: torch.Tensor,
                 x0: torch.Tensor, y0: torch.Tensor, tile_h: int,
                 tile_w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``gather_tiles`` in one launch: the clamp runs in the kernel,
        which writes the tiles and both clamped origins.  Takes (N,) int32
        views of any stride (a stride-0 expanded level too)."""
        stack = pyr.stack
        if not stack.is_cuda:
            raise ValueError("tile_gather kernel needs CUDA tensors")
        if stack.dtype is not torch.float32 or stack.dim() != 2 \
                or not stack.is_contiguous():
            raise ValueError("stack must be a contiguous (Hs, Ws) float32")
        n = int(x0.shape[0])
        if not (level.dtype is x0.dtype is y0.dtype is torch.int32) \
                or not (level.shape == x0.shape == y0.shape == (n,)) \
                or not (level.device == x0.device == y0.device
                        == stack.device):
            raise ValueError(f"level, x0, y0 must be (N,) int32 tensors on "
                             f"{stack.device}")
        if tile_w > stack.shape[1] or tile_h > TAIL_ROWS + 8:
            raise ValueError("tile larger than the padded layout backs")
        out = torch.empty((n, tile_h, tile_w), dtype=torch.float32,
                          device=stack.device)
        org = torch.empty((2, n), dtype=torch.int32, device=stack.device)
        fn = cuda_build.function("tile_gather", _K1_ARGTYPES)
        err = fn(stack.data_ptr(), int(stack.shape[1]), pyr.kernel_table(),
                 level.data_ptr(), level.stride(0), x0.data_ptr(),
                 x0.stride(0), y0.data_ptr(), y0.stride(0), out.data_ptr(),
                 org.data_ptr(), n, int(tile_h), int(tile_w),
                 cuda_build.raw_stream(stack.device))
        cuda_build.check(err, "tile_gather")
        if torch.cuda.is_current_stream_capturing():
            graphed.record_launch("tile_gather")
        else:
            self.launches += 1
        return out, org[0], org[1]

    def batched(self, stack: torch.Tensor, shapes, level: torch.Tensor,
                x0: torch.Tensor, y0: torch.Tensor, tile_h: int,
                tile_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """B streams in one launch: stack (B, Hs, Ws), each stream's
        (Hs, Ws) slab contiguous (stream stride 0 for a shared stack);
        level, x0, y0 (B, N) int32 of any strides.  Returns tiles
        (B, N, tile_h, tile_w) and clamped origins (B, 2, N)."""
        if not stack.is_cuda:
            raise ValueError("tile_gather kernel needs CUDA tensors")
        Ws, Hs, _ = padded_layout(shapes)
        if stack.dtype is not torch.float32 or stack.dim() != 3 \
                or tuple(stack.shape[1:]) != (Hs, Ws) \
                or stack.stride()[1:] != (Ws, 1):
            raise ValueError(f"stack must be (B, {Hs}, {Ws}) float32 with "
                             f"contiguous streams, got {tuple(stack.shape)} "
                             f"strides {stack.stride()}")
        B, n = int(stack.shape[0]), int(x0.shape[1])
        for name, a in (("level", level), ("x0", x0), ("y0", y0)):
            if a.dtype is not torch.int32 or tuple(a.shape) != (B, n) \
                    or a.device != stack.device:
                raise ValueError(f"{name} must be ({B}, {n}) int32 on "
                                 f"{stack.device}, got {a.dtype} "
                                 f"{tuple(a.shape)} on {a.device}")
        if tile_w > Ws or tile_h > TAIL_ROWS + 8:
            raise ValueError("tile larger than the padded layout backs")
        out = torch.empty((B, n, tile_h, tile_w), dtype=torch.float32,
                          device=stack.device)
        org = torch.empty((B, 2, n), dtype=torch.int32, device=stack.device)
        fn = cuda_build.function("tile_gather_batched", _K1B_ARGTYPES,
                                 library="tile_gather")
        err = fn(stack.data_ptr(), stack.stride(0), Ws, _kernel_table(shapes),
                 level.data_ptr(), level.stride(0), level.stride(1),
                 x0.data_ptr(), x0.stride(0), x0.stride(1), y0.data_ptr(),
                 y0.stride(0), y0.stride(1), out.data_ptr(), org.data_ptr(),
                 n, int(tile_h), int(tile_w), B,
                 cuda_build.raw_stream(stack.device))
        cuda_build.check(err, "tile_gather_batched")
        if torch.cuda.is_current_stream_capturing():
            graphed.record_launch("tile_gather")
        else:
            self.launches += 1
        return out, org


tile_gather_kernel = _TileGather()


def gather_tiles_plain(pyr: PaddedPyramid, level: torch.Tensor,
                       x0: torch.Tensor, y0: torch.Tensor, tile_h: int,
                       tile_w: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's plain twin: the clamp as torch ops against the device level
    table, then a flat-index gather (as ``pallas_tiles.gather_tiles``' XLA
    fallback)."""
    tab = pyr.level_table()
    lv = torch.clamp(level.to(torch.int64), 0, len(pyr.shapes) - 1)
    W, H, off = tab[0][lv], tab[1][lv], tab[2][lv]
    zero = torch.zeros_like(W)
    x0c = torch.clamp(x0.to(torch.int32), zero,
                      torch.clamp(W - tile_w, min=0))
    y0c = torch.clamp(y0.to(torch.int32), zero,
                      torch.clamp(H - tile_h, min=0))
    dev = pyr.stack.device
    r = torch.arange(tile_h, dtype=torch.int64, device=dev)
    c = torch.arange(tile_w, dtype=torch.int64, device=dev)
    yy = (y0c + off).to(torch.int64)[:, None, None] + r[None, :, None]
    xx = x0c.to(torch.int64)[:, None, None] + c[None, None, :]
    tiles = pyr.stack.reshape(-1)[yy * pyr.stack.shape[1] + xx]
    return tiles, x0c, y0c


def _shapes_arg(shapes) -> list:
    return [int(v) for hw in shapes for v in hw]


def _shapes_of(flat) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(flat[i]), int(flat[i + 1]))
                 for i in range(0, len(flat), 2))


@torch.library.custom_op(
    "svo_torch::tile_gather", mutates_args=(),
    schema="(Tensor stack, Tensor level, Tensor x0, Tensor y0, int tile_h, "
           "int tile_w, int[] shapes) -> (Tensor, Tensor)")
def tile_gather_op(stack, level, x0, y0, tile_h, tile_w, shapes):
    """``gather_tiles`` for a stream batch: stack (B, Hs, Ws), level, x0,
    y0 (B, N) -> (tiles (B, N, tile_h, tile_w), origins (B, 2, N)); one
    launch of K1 on the card, the plain twin stream by stream on the CPU.
    ``shapes`` is the level shapes, flattened.  ``gather_tiles`` reaches it
    under vmap, through the rule below."""
    shp = _shapes_of(shapes)
    if stack.is_cuda:
        return tile_gather_kernel.batched(stack, shp, level, x0, y0,
                                          tile_h, tile_w)
    outs = [gather_tiles_plain(PaddedPyramid(stack[b], shp), level[b],
                               x0[b], y0[b], tile_h, tile_w)
            for b in range(stack.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([torch.stack(o[1:]) for o in outs]))


def _stream_major(info, in_dims, *args, contiguous=True):
    """Each tensor argument with the stream axis first (an unbatched one
    expanded with stream stride 0), each stream's slab made contiguous
    unless ``contiguous`` is False."""
    out = []
    for a, d in zip(args, in_dims):
        a = a.expand((info.batch_size,) + tuple(a.shape)) if d is None \
            else a.movedim(d, 0)
        inner, acc = [], 1
        for n in reversed(a.shape[1:]):
            inner.append(acc)
            acc *= n
        out.append(a if not contiguous
                   or a.stride()[1:] == tuple(reversed(inner))
                   else a.contiguous())
    return out


def _tile_gather_vmap(info, in_dims, stack, level, x0, y0, tile_h, tile_w,
                      shapes):
    # the kernel reads the requests at any strides
    stack, = _stream_major(info, in_dims[:1], stack)
    level, x0, y0 = _stream_major(info, in_dims[1:4], level, x0, y0,
                                  contiguous=False)
    if stack.dim() != 3:
        raise NotImplementedError("tile_gather batches one stream axis")
    return tile_gather_op(stack, level, x0, y0, tile_h, tile_w,
                          shapes), (0, 0)


torch.library.register_vmap("svo_torch::tile_gather", _tile_gather_vmap)


def gather_tiles(pyr: PaddedPyramid, level: torch.Tensor, x0: torch.Tensor,
                 y0: torch.Tensor, tile_h: int, tile_w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather (N, tile_h, tile_w) integer tiles at per-item pyramid level.

    (x0, y0) are requested origins in LEVEL coords (int32); they are clamped
    into the level.  Returns (tiles, x0c, y0c) with the clamped origins
    (int32).  A CUDA stack goes through kernel K1 (one launch, nothing
    else), a CPU stack through its plain twin; a stream batch under vmap
    goes through ``tile_gather_op`` (one launch for every stream)."""
    if is_batched(pyr.stack, level, x0, y0):
        tiles, org = tile_gather_op(pyr.stack, level, x0, y0, tile_h,
                                    tile_w, _shapes_arg(pyr.shapes))
        return tiles, org[0], org[1]
    if pyr.stack.is_cuda:
        return tile_gather_kernel(pyr, level, x0, y0, tile_h, tile_w)
    return gather_tiles_plain(pyr, level, x0, y0, tile_h, tile_w)
