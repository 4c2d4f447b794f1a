"""The plain reference of the benchmark: a frozen copy of the port's eager
step body (``core/fused._vo_step``) and host pipeline
(``core/pipeline.FrameHandler``) with every CUDA kernel replaced by its
plain twin and every CUDA graph by the eager body.

It imports torch and numpy only, never the program: a later change to the
program does not change what it is held to.  Modules keep the port's
layout; ``core/graphed.py``, ``ops/align_kernel.py`` and
``parallel/gspmd.py`` are small stand-ins for the port's modules of the
same names.
"""

from __future__ import annotations

import torch

from svo_bench.reference.svo.config import Config  # noqa: F401


def resolve_device(device=None) -> torch.device:
    """The device a reference call runs on: ``cuda`` unless the caller
    asks for another."""
    return torch.device("cuda" if device is None else device)


def is_batched(*tensors) -> bool:
    """Whether any tensor is a batch under ``torch.func.vmap``."""
    return any(torch._C._functorch.is_batchedtensor(t) for t in tensors)
