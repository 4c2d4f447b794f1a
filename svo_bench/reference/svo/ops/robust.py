"""Robust cost weights and scale estimators.

Port of ``rpg_svo_tpu/ops/robust.py`` (vikit's robust_cost.h: Tukey and
Huber weights, MAD scale, masked median).  Medians sort with masked entries
pushed to +inf and index the (n_valid // 2)-th element, as the JAX
package does, so they need no host round trip.
"""

from __future__ import annotations

import torch

MAD_NORMALIZER = 1.4826
TUKEY_B = 4.6851


def _masked_sorted_at_half(x: torch.Tensor, mask: torch.Tensor):
    n = torch.sum(mask)
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))[0]
    idx = torch.clamp(n // 2, 0, x.shape[0] - 1)
    # index_select keeps the index on the device (a 0-d tensor subscript
    # would be read back to the host)
    return s.index_select(0, idx.reshape(1))[0], n


def mad_scale(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Robust sigma: 1.4826 * median(|x|) over the masked entries."""
    v, _ = _masked_sorted_at_half(torch.abs(x), mask)
    return MAD_NORMALIZER * v


def tukey_weight(x_normalized: torch.Tensor,
                 b: float = TUKEY_B) -> torch.Tensor:
    u = x_normalized / b
    w = 1.0 - u * u
    return torch.where(torch.abs(u) < 1.0, w * w, torch.zeros_like(w))


def huber_weight(x_normalized: torch.Tensor, k: float = 1.345) -> torch.Tensor:
    ax = torch.abs(x_normalized)
    return torch.where(ax < k, torch.ones_like(ax),
                       k / torch.clamp(ax, min=1e-12))


def masked_median(x: torch.Tensor, mask: torch.Tensor,
                  default: float = 0.0) -> torch.Tensor:
    """Median of the masked entries (ref: vk::getMedian via nth_element)."""
    v, n = _masked_sorted_at_half(x, mask)
    return torch.where(n > 0, v, torch.full_like(v, default))
