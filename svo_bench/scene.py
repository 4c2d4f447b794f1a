"""The benchmark's scene and camera path, in plain PyTorch.

A textured plane z = 0 (a sum of sinusoids: the bench scene's spectrum,
with directions and phases drawn from numpy's generator with the run's
seed) seen by a down-looking pinhole camera that flies a
closed circle with a small wobble in height and attitude.  Frames are
rendered on the device in a few large calls, quantised to uint8 as a
camera delivers them, and kept on the host.  This module is the
benchmark's own: neither the program nor the reference makes the inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


class Path(NamedTuple):
    """A lap of P frames: T_w_c as rotations (P, 3, 3) and positions (P, 3),
    float64."""
    R_wc: np.ndarray
    t_wc: np.ndarray


def texture(seed: int, n_waves: int = 48, min_freq: float = 4.0,
            max_freq: float = 240.0):
    """(amp (K,), freq (K, 2) rad/m, phase (K,)) of the bench texture.

    The waves' wavelengths and amplitudes are the bench scene's spectrum
    (numpy's generator with seed 0), the same in every run, so that every
    run's scene offers the same amount of detail to the detector and the
    depth filter; the run's seed draws each wave's direction and phase."""
    mag = np.exp(np.random.default_rng(0).uniform(
        np.log(min_freq), np.log(max_freq), n_waves))
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n_waves)
    freq = np.stack([mag * np.cos(ang), mag * np.sin(ang)], axis=-1)
    amp = 260.0 / (1.0 + 0.02 * mag)
    amp = amp / amp.sum() * 420.0
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    return amp, freq, phase


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + math.sin(th) / th * K \
        + (1 - math.cos(th)) / th ** 2 * K @ K


_LOOK_DOWN = np.diag([1.0, -1.0, -1.0])


def frames_per_lap(p: dict) -> int:
    """Frames in one lap of the circle at the path's step per frame."""
    return int(round(2 * math.pi * p["radius"] / p["step"]))


def circle_path(p: dict) -> Path:
    """The closed circle of the path file ``p``: radius, height, step per
    frame and the wobble amplitudes (height, yaw, pitch and roll, each a
    whole number of periods per lap, so that the lap closes)."""
    n = frames_per_lap(p)
    w = p["wobble"]
    R, t = [], []
    for i in range(n):
        a = 2 * math.pi * i / n
        R.append(_so3_exp(np.array([w["roll"] * math.cos(2 * a),
                                    w["pitch"] * math.sin(2 * a),
                                    w["yaw"] * math.sin(a)])) @ _LOOK_DOWN)
        t.append([p["radius"] * math.cos(a), p["radius"] * math.sin(a),
                  p["height"] + w["height"] * math.sin(3 * a)])
    return Path(np.stack(R), np.asarray(t, np.float64))


def _bearings(cam: Camera, device) -> torch.Tensor:
    """(H, W, 3) unit bearing of every pixel in the camera frame."""
    ys = torch.arange(cam.height, dtype=torch.float32, device=device)
    xs = torch.arange(cam.width, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    f = torch.stack([(gx - cam.cx) / cam.fx, (gy - cam.cy) / cam.fy,
                     torch.ones_like(gx)], dim=-1)
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)


def _render(cam: Camera, tex, R_wc: np.ndarray, t_wc: np.ndarray,
            device):
    """(image (N, H, W) float32 in [0, 255], depth (N, H, W)) of the plane
    from N poses on ``device``; depth is the distance along each pixel's
    unit bearing, inf where the ray misses the plane."""
    f_c = _bearings(cam, device)
    amp, freq, phase = (torch.as_tensor(np.asarray(a, np.float32),
                                        device=device) for a in tex)
    R = torch.as_tensor(R_wc, dtype=torch.float32, device=device)
    t = torch.as_tensor(t_wc, dtype=torch.float32, device=device)
    d_w = (R[:, None, None] * f_c[None, :, :, None, :]).sum(-1)
    dz = d_w[..., 2]
    depth = -t[:, 2, None, None] / torch.clamp(dz, max=-1e-6)
    hit = (dz < -1e-6) & (depth > 0)
    depth = torch.where(hit, depth, torch.full_like(depth, float("inf")))
    xy = t[:, None, None, :2] \
        + torch.where(hit, depth, torch.zeros_like(depth))[..., None] \
        * d_w[..., :2]
    val = torch.zeros_like(depth)
    for k in range(amp.shape[0]):
        val = val + amp[k] * torch.sin(xy[..., 0] * freq[k, 0]
                                       + xy[..., 1] * freq[k, 1] + phase[k])
    img = torch.where(hit, torch.clamp(127.5 + val, 0.0, 255.0),
                      torch.zeros_like(val))
    return img, depth


def render_lap(cam: Camera, tex, path: Path, device,
               block: int = 32) -> np.ndarray:
    """Every frame of the lap as uint8 (P, H, W) on the host, rendered on
    ``device`` ``block`` frames at a time."""
    out = []
    for s in range(0, len(path.R_wc), block):
        img, _ = _render(cam, tex, path.R_wc[s:s + block],
                         path.t_wc[s:s + block], device)
        out.append(torch.round(img).to(torch.uint8).cpu())
    return torch.cat(out).numpy()


def depth_map(cam: Camera, path: Path, i: int, device) -> torch.Tensor:
    """(H, W) float32 ground-truth depth of frame i on ``device``."""
    return _render(cam, ([0.0], [[0.0, 0.0]], [0.0]),
                   path.R_wc[i:i + 1], path.t_wc[i:i + 1], device)[1][0]
