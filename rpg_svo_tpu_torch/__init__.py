"""rpg_svo_tpu_torch — the PyTorch and CUDA port of rpg_svo_tpu.

Semi-direct monocular visual odometry (SVO: Forster, Pizzoli, Scaramuzza,
ICRA 2014) on an NVIDIA Hopper card.  The module layout mirrors
``rpg_svo_tpu/`` file for file; the JAX package is the reference the tests
hold this one against.  This package imports ``torch`` and numpy only.

Layout
------
- ``geometry``  SE3, cameras (pinhole, ATAN, Omni), triangulation, small
                closed-form solves
- ``ops``       pyramids, tile gather (CUDA kernel K1), sparse image
                alignment (CUDA kernel K2), feature alignment, matcher,
                pose and structure refinement, detector, KLT, homography
- ``core``      map pools, reprojector, depth filter, bundle adjustment,
                the fused tracking step, the two-view bootstrap, the
                host pipeline (``core.pipeline.FrameHandler``),
                checkpoints and map checks
- ``io``        camera YAMLs, dataset readers, trajectories, traces, PLY,
                experiment YAMLs
- ``native``    the C++ image loader and prefetch pool, built with g++ on
                first use
- ``analysis``  trajectory errors (ATE, RPE) and depth errors
- ``tools``     the offline benchmark driver
- ``utils``     synthetic scene renderers
- ``viz``       per-frame records and overlays
- ``csrc``      the CUDA sources, built with nvcc on first use

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a machine without CUDA a call that did not ask for the CPU raises.
"""

from __future__ import annotations

import torch

from rpg_svo_tpu_torch.config import Config  # noqa: F401

__version__ = "0.1.0"

# Geometry contractions stay full float32.  A float32 matmul on the card
# may otherwise run in TF32 (10-bit mantissa); on the TPU the analogous bf16
# truncation moved trajectory accuracy from 1.95 to 2.40 mm, so neither
# matmuls nor cuDNN convolutions may round their inputs.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and not
    available — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rpg_svo_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return dev
