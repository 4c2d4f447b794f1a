"""What the entry adapters share: the result of one step, the program's
configuration and camera from a configuration file, and poses."""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class Result(NamedTuple):
    """One step's outputs on the host, one row per stream."""
    R_wc: np.ndarray        # (B, 3, 3)
    t_wc: np.ndarray        # (B, 3)
    keyframe: np.ndarray    # (B,) bool
    failed: np.ndarray      # (B,) bool
    spans: List[dict]       # the entry's own per-frame records (may be [])


def program_setup(cfg_file: dict):
    """(Config, camera, (ncx, ncy)) of the program for a configuration
    file; raises where the Config differs from what the file states."""
    from rpg_svo_tpu_torch import config
    from rpg_svo_tpu_torch.geometry.cameras import PinholeCamera
    from rpg_svo_tpu_torch.ops.detector import grid_dims
    cfg = getattr(config, f"{cfg_file['preset']}_preset")(
        **cfg_file["overrides"])
    for group in ("settings", "assumed"):
        for k, v in cfg_file[group].items():
            if getattr(cfg, k) != v:
                raise ValueError(f"{cfg_file['name']}: {k} = "
                                 f"{getattr(cfg, k)!r}, the file states {v!r}")
    c = cfg_file["camera"]
    cam = PinholeCamera.make(c["width"], c["height"], c["fx"], c["fy"],
                             c["cx"], c["cy"])
    h, w = cfg_file["img_shape"]
    return cfg, cam, grid_dims(w, h, cfg.grid_size)


def T_f_w(R_wc: np.ndarray, t_wc: np.ndarray, device):
    """The program's SE3 T_f_w of a camera pose T_w_c."""
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    return SE3(torch.as_tensor(R_wc.T, dtype=torch.float32, device=device),
               torch.as_tensor(-R_wc.T @ t_wc, dtype=torch.float32,
                               device=device))


def host_rows(R_fw: torch.Tensor, t: torch.Tensor, flags: torch.Tensor):
    """(R_wc (B, 3, 3), t (B, 3), flags (B, k)) on the host in one copy:
    rotations R_fw (B, 3, 3), a position or translation (B, 3) and
    per-stream flags (B, k)."""
    B = R_fw.shape[0]
    row = torch.cat([R_fw.reshape(B, 9), t.reshape(B, 3),
                     flags.reshape(B, -1).to(R_fw.dtype)], dim=1).cpu()
    row = row.double().numpy()
    return row[:, :9].reshape(B, 3, 3).transpose(0, 2, 1), row[:, 9:12], \
        row[:, 12:]
