"""Synthetic textured scenes, rendered on the device.

Port of ``rpg_svo_tpu/utils/synthetic.py``: the plane scene the bench uses
(a z = 0 plane carrying a sum-of-sinusoids texture) and the sinusoidal
height field that stands in for the reference's ``sin2_tex2_h1_v8_d``
Blender scene, seen by a down-looking camera (by default the reference
test camera: pinhole 752x480, f = 315.5, c = (376, 240); the renderers
take any camera of ``geometry/cameras.py``, as they only call
``cam2world``).  Per frame: the image, the ground-truth T_w_c and the
depth along each bearing ray.  The texture's parameters come from numpy's
generator with the given seed, as in the JAX package, so both packages
render the same scene.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from rpg_svo_tpu_torch import resolve_device
from rpg_svo_tpu_torch.core import graphed
from rpg_svo_tpu_torch.geometry.cameras import PinholeCamera
from rpg_svo_tpu_torch.geometry.se3 import SE3


def reference_test_camera(width: int = 752,
                          height: int = 480) -> PinholeCamera:
    """The reference's test camera (svo/test/test_pipeline.cpp:48)."""
    return PinholeCamera.make(width, height, 315.5, 315.5,
                              width / 2.0, height / 2.0)


@dataclasses.dataclass(frozen=True)
class Texture:
    """Sum of sinusoids: amp (K,), freq (K, 2) rad/m, phase (K,)."""
    amp: np.ndarray
    freq: np.ndarray
    phase: np.ndarray

    @staticmethod
    def make(seed: int = 0, n_waves: int = 48, min_freq: float = 4.0,
             max_freq: float = 240.0,
             flat_spectrum: bool = False) -> "Texture":
        rng = np.random.default_rng(seed)
        mag = np.exp(rng.uniform(np.log(min_freq), np.log(max_freq),
                                 n_waves))
        ang = rng.uniform(0, 2 * np.pi, n_waves)
        freq = np.stack([mag * np.cos(ang), mag * np.sin(ang)], axis=-1)
        amp = np.ones(n_waves) if flat_spectrum \
            else 260.0 / (1.0 + 0.02 * mag)
        amp = amp / amp.sum() * 420.0
        phase = rng.uniform(0, 2 * np.pi, n_waves)
        return Texture(amp, freq, phase)

    @staticmethod
    def make_fine(seed: int = 0, n_waves: int = 48) -> "Texture":
        """Sharp texture whose detail reaches ~2 px at level 0 for a camera
        2 m above the surface (f = 315.5): corners then lie on level 0, as
        in the reference's photographed test texture."""
        return Texture.make(seed=seed, n_waves=n_waves, min_freq=30.0,
                            max_freq=500.0, flat_spectrum=True)

    def on(self, device) -> "Texture":
        """The texture with float32 tensors on ``device`` (a renderer's
        graph reads them as inputs)."""
        return Texture(*(torch.as_tensor(np.asarray(a, np.float32),
                                         device=device)
                         for a in (self.amp, self.freq, self.phase)))

    def eval(self, xy: torch.Tensor) -> torch.Tensor:
        """xy (..., 2) world coords -> intensity (...) in [0, 255]."""
        amp, freq, phase = (
            a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a, np.float32), device=xy.device)
            for a in (self.amp, self.freq, self.phase))
        arg = xy[..., None, 0] * freq[:, 0] + xy[..., None, 1] * freq[:, 1]
        val = torch.sum(amp * torch.sin(arg + phase), dim=-1)
        return torch.clamp(127.5 + val, 0.0, 255.0)


# a pytree node, so that a texture of tensors is a renderer graph's input
pytree.register_pytree_node(
    Texture, lambda t: ([t.amp, t.freq, t.phase], None),
    lambda leaves, _: Texture(*leaves),
    serialized_type_name="rpg_svo_tpu_torch.utils.synthetic.Texture")


def look_down_pose(x: float, y: float, z: float, yaw: float = 0.0,
                   pitch: float = 0.0, roll: float = 0.0,
                   device="cpu") -> SE3:
    """T_w_c of a camera at (x, y, z) looking down the world -z axis,
    with small attitude perturbations."""
    R_base = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                           [0.0, 0.0, -1.0]], device=device)
    pert = SE3.exp(torch.tensor([0, 0, 0, roll, pitch, yaw],
                                dtype=torch.float32, device=device))
    return SE3(pert.R @ R_base,
               torch.tensor([x, y, z], dtype=torch.float32, device=device))


def circle_trajectory(n_frames: int, radius: float = 0.4,
                      height: float = 1.5, wobble: float = 0.05,
                      revolutions: float = 1.0, device="cpu") -> List[SE3]:
    """Down-looking circular sweep (the paper's aerial rig)."""
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * revolutions * i / max(n_frames - 1, 1)
        poses.append(look_down_pose(
            radius * np.cos(a), radius * np.sin(a),
            height + wobble * np.sin(3 * a),
            yaw=0.1 * np.sin(a), pitch=0.03 * np.sin(2 * a),
            roll=0.03 * np.cos(2 * a), device=device))
    return poses


def line_trajectory(n_frames: int, speed: float = 0.02,
                    height: float = 1.5, device="cpu") -> List[SE3]:
    """Straight lateral sweep (controlled disparity)."""
    return [look_down_pose(i * speed, 0.0, height, device=device)
            for i in range(n_frames)]


def _pixel_rays(cam, T_w_c: SE3, shape: Tuple[int, int]) -> torch.Tensor:
    """(H, W, 3) world directions of the unit bearings of every pixel."""
    H, W = shape
    dev = T_w_c.t.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    return T_w_c.rotate(cam.cam2world(torch.stack([gx, gy], dim=-1)))


def render_frame(cam, tex: Texture, T_w_c: SE3,
                 shape: Tuple[int, int] = (480, 752)):
    """(image (H, W) float32 in [0, 255], depth (H, W) float32) of the
    plane z = 0 on the pose's device; depth is the distance along the unit
    bearing ray."""
    d_w = _pixel_rays(cam, T_w_c, shape)
    cz = T_w_c.t[2]
    dz = d_w[..., 2]
    dz_safe = torch.where(torch.abs(dz) < 1e-6, torch.full_like(dz, -1e-6),
                          dz)
    depth = -cz / dz_safe
    depth = torch.where((dz < -1e-6) & (depth > 0), depth,
                        torch.full_like(depth, float("inf")))
    pw = T_w_c.t + depth[..., None] * d_w
    img = tex.eval(pw[..., :2])
    img = torch.where(torch.isfinite(depth), img, torch.zeros_like(img))
    return img, depth


@dataclasses.dataclass(frozen=True)
class SineSurface:
    """Height field z = amp * sin(kx x + p0) * sin(ky y + p1).

    A proxy for the reference's ``sin2_tex2_h1_v8_d`` Blender scene
    (svo/test/README.md, svo/test/test_utils.h:30-51): depth varies per
    pixel, so warps are affine and the depth filter sees a non-constant
    field.  Rays hit the surface once while slope * tan(half-FOV) < 1;
    the defaults give 0.31 * 1.19 = 0.37 for the reference test camera."""
    amp: float = 0.2
    kx: float = 2.0 * np.pi / 4.0      # wavelength 4 m
    ky: float = 2.0 * np.pi / 4.0
    p0: float = 0.37
    p1: float = 1.13

    def height(self, xy: torch.Tensor) -> torch.Tensor:
        return self.amp * torch.sin(self.kx * xy[..., 0] + self.p0) \
            * torch.sin(self.ky * xy[..., 1] + self.p1)


def render_surface_frame(cam, tex: Texture, surf: SineSurface, T_w_c: SE3,
                         shape: Tuple[int, int] = (480, 752),
                         n_bisect: int = 40):
    """(image, depth) of the textured height field on the pose's device.

    The ray-surface hit by bisection on the ray parameter t of
    g(t) = z(t) - h(x(t), y(t)), bracketed by the planes z = +-amp; g is
    monotone under the slope bound, so 40 bisections reach float32
    precision.  depth = t along the unit bearing ray."""
    d_w = _pixel_rays(cam, T_w_c, shape)
    c = T_w_c.t
    dz = d_w[..., 2]
    dz_safe = torch.where(torch.abs(dz) < 1e-6, torch.full_like(dz, -1e-6),
                          dz)
    down = dz < -1e-6
    # the bracket: t at z = +amp (above every surface point) .. z = -amp
    lo = torch.clamp((surf.amp - c[2]) / dz_safe, min=0.0)
    hi = (-surf.amp - c[2]) / dz_safe
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        p = c + mid[..., None] * d_w
        below = p[..., 2] - surf.height(p[..., :2]) < 0.0   # past it
        hi = torch.where(below, mid, hi)
        lo = torch.where(below, lo, mid)
    depth = 0.5 * (lo + hi)
    depth = torch.where(down & (depth > 0), depth,
                        torch.full_like(depth, float("inf")))
    pw = c + depth[..., None] * d_w
    img = tex.eval(pw[..., :2])
    img = torch.where(torch.isfinite(depth), img, torch.zeros_like(img))
    return img, depth


# the datasets' renderers, jitted as the JAX package jits its datasets'
# closures over the camera, texture and shape (rpg_svo_tpu/utils/
# synthetic.py:253, 281): here the texture is an input (``Texture.on``)
_render_surface = graphed.jit(render_surface_frame)
_render_plane = graphed.jit(render_frame)


class SurfaceDataset:
    """Rendered sequence over the sinusoidal surface with ground truth:
    752x480 frames through the reference test camera, ~2 m above the
    surface, a diagonal sweep like the reference matcher test's pose pair
    (svo/test/test_matcher.cpp:52-57) with a mild attitude wobble.  Frames
    render on ``device`` (``cuda`` unless the caller passes another)."""

    def __init__(self, n_frames: int = 20, seed: int = 0,
                 shape: Tuple[int, int] = (480, 752),
                 height: float = 2.0, step: float = 0.03,
                 surf: SineSurface | None = None,
                 tex: Texture | None = None, device=None):
        self.device = resolve_device(device)
        self.cam = reference_test_camera(shape[1], shape[0])
        self.tex = tex if tex is not None else Texture.make_fine(seed=seed)
        self.surf = surf if surf is not None else SineSurface()
        self._tex = self.tex.on(self.device)
        self.shape = shape
        self.poses = [
            look_down_pose(0.1131 + step * i, 0.1131 + step * 0.97 * i,
                           height, yaw=0.02 * np.sin(0.4 * i),
                           pitch=0.01 * np.sin(0.3 * i),
                           roll=0.01 * np.cos(0.5 * i), device=self.device)
            for i in range(n_frames)]

    def __len__(self):
        return len(self.poses)

    def frame(self, i: int):
        """Returns (img, depth, T_w_c)."""
        img, depth = _render_surface(self.cam, self._tex, self.surf,
                                     self.poses[i], self.shape)
        return img, depth, self.poses[i]


class SyntheticDataset:
    """Rendered frames with ground truth; frames render on ``device``
    (``cuda`` unless the caller passes another)."""

    def __init__(self, n_frames: int = 60, seed: int = 0,
                 trajectory: str = "circle",
                 shape: Tuple[int, int] = (480, 752),
                 tex: Texture | None = None, device=None, **traj_kw):
        self.device = resolve_device(device)
        self.cam = reference_test_camera(shape[1], shape[0])
        self.tex = tex if tex is not None else Texture.make(seed=seed)
        self._tex = self.tex.on(self.device)
        self.shape = shape
        if trajectory == "circle":
            self.poses = circle_trajectory(n_frames, device=self.device,
                                           **traj_kw)
        elif trajectory == "line":
            self.poses = line_trajectory(n_frames, device=self.device,
                                         **traj_kw)
        else:
            raise ValueError(trajectory)

    def __len__(self):
        return len(self.poses)

    def frame(self, i: int):
        """Returns (img, depth, T_w_c)."""
        img, depth = _render_plane(self.cam, self._tex, self.poses[i],
                                   self.shape)
        return img, depth, self.poses[i]
