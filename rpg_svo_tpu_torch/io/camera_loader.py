"""Camera YAML loader.

Port of ``rpg_svo_tpu/io/camera_loader.py`` (vikit's camera_loader, as the
live node reads it, svo_ros/src/vo_node.cpp:72-73): the flat ``cam_*`` keys
of ``svo_ros/param/camera_pinhole.yaml`` and ``camera_atan.yaml``.  ATAN
files hold PTAM-convention normalized intrinsics (fx, cx relative to the
width, fy, cy to the height, with the half-pixel offset); Pinhole files
hold pixels and radial-tangential distortion d0..d3; Ocam files name a
``calib_results.txt`` or hold its polynomials as flat keys.  Needs no
YAML library.
"""

from __future__ import annotations

import os
from typing import Dict

from rpg_svo_tpu_torch.geometry.cameras import (
    ATANCamera, OmniCamera, PinholeCamera, load_ocam_calib)


def _parse_flat_yaml(path: str) -> Dict[str, str]:
    """Parse the flat ``key: value`` YAML subset these files use."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            k, v = line.split(":", 1)
            out[k.strip()] = v.strip()
    return out


def load_camera_yaml(path: str):
    """A Pinhole, ATAN or Omni camera from a ``cam_*`` YAML file.

    ``cam_model: Ocam`` takes either ``cam_calib_file: <path>`` (an
    ocam-toolbox calib_results.txt, relative to the YAML) or flat
    ``cam_poly`` / ``cam_inv_poly`` / ``cam_xc`` / ``cam_yc`` /
    ``cam_c/d/e`` keys."""
    kv = _parse_flat_yaml(path)
    model = kv.get("cam_model", "Pinhole").lower()
    if model == "ocam":
        if "cam_calib_file" in kv:
            calib = kv["cam_calib_file"]
            if not os.path.isabs(calib):
                calib = os.path.join(os.path.dirname(path), calib)
            return load_ocam_calib(calib)
        poly = [float(t) for t in kv["cam_poly"].split()]
        inv_poly = [float(t) for t in kv["cam_inv_poly"].split()]
        return OmniCamera.make(
            int(float(kv["cam_width"])), int(float(kv["cam_height"])),
            poly, inv_poly, float(kv["cam_xc"]), float(kv["cam_yc"]),
            float(kv.get("cam_c", 1.0)), float(kv.get("cam_d", 0.0)),
            float(kv.get("cam_e", 0.0)))
    w = int(float(kv["cam_width"]))
    h = int(float(kv["cam_height"]))
    fx = float(kv["cam_fx"])
    fy = float(kv["cam_fy"])
    cx = float(kv["cam_cx"])
    cy = float(kv["cam_cy"])
    if model == "atan":
        # ATANCamera.make applies the PTAM normalized convention
        return ATANCamera.make(w, h, fx, fy, cx, cy,
                               float(kv.get("cam_d0", 0.0)))
    d = [float(kv.get(f"cam_d{i}", 0.0)) for i in range(4)]
    return PinholeCamera.make(w, h, fx, fy, cx, cy, *d)
