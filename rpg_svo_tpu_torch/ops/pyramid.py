"""Image pyramid construction.

Port of ``rpg_svo_tpu/ops/pyramid.py``: each level is the 2x2 block mean
of the previous one (``vk::halfSample``, svo/src/frame.cpp:156-165),
written as a reshape-mean.  The JAX package's bf16 hi/lo matmul
construction is a TPU cost trick and is not ported; its CPU path is this
same reshape-mean.  ``build_lk_pyramid`` blurs before each halving, for
the bootstrap's KLT tracker.  Images are float32 in [0, 255].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def half_sample(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H//2, W//2) by 2x2 averaging."""
    H, W = img.shape
    h, w = H // 2, W // 2
    return img[: h * 2, : w * 2].reshape(h, 2, w, 2).mean(dim=(1, 3))


def build_pyramid(img: torch.Tensor, n_levels: int) -> Tuple[torch.Tensor, ...]:
    levels = [img.to(torch.float32)]
    for _ in range(n_levels - 1):
        levels.append(half_sample(levels[-1]))
    return tuple(levels)


def binomial_blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial ([1, 4, 6, 4, 1] / 16) low-pass with
    replicated edges, rows first, the taps summed in order."""
    k = (0.0625, 0.25, 0.375, 0.25, 0.0625)
    H, W = img.shape
    dev = img.device
    rows = torch.clamp(torch.arange(-2, H + 2, device=dev), 0, H - 1)
    p = img[rows]
    v = k[0] * p[0:H]
    for i in range(1, 5):
        v = v + k[i] * p[i:i + H]
    cols = torch.clamp(torch.arange(-2, W + 2, device=dev), 0, W - 1)
    p = v[:, cols]
    out = k[0] * p[:, 0:W]
    for i in range(1, 5):
        out = out + k[i] * p[:, i:i + W]
    return out


def build_lk_pyramid(img: torch.Tensor,
                     n_levels: int) -> Tuple[torch.Tensor, ...]:
    """Antialiased pyramid of the KLT tracker: blur, then 2x2 mean (the
    box pyramid of the VO stages aliases under large displacements)."""
    levels = [img.to(torch.float32)]
    for _ in range(n_levels - 1):
        levels.append(half_sample(binomial_blur(levels[-1])))
    return tuple(levels)


def pyramid_shapes(shape: Tuple[int, int],
                   n_levels: int) -> List[Tuple[int, int]]:
    out = [tuple(shape)]
    for _ in range(n_levels - 1):
        h, w = out[-1]
        out.append((h // 2, w // 2))
    return out


def build_padded_pyramid(img: torch.Tensor, n_levels: int):
    """The PaddedPyramid stack of ``img`` (the layout every sampler reads)."""
    from rpg_svo_tpu_torch.ops.tiles import PaddedPyramid
    return PaddedPyramid.from_levels(build_pyramid(img, n_levels))
