"""Camera models as plain functions on torch tensors.

Port of ``rpg_svo_tpu/geometry/cameras.py``: the pinhole with
radial-tangential distortion and its distortion-free subclass, the ATAN
(FoV) camera and the omnidirectional Ocam camera, the reference's three
camera options ("ATAN, Pinhole or Ocam", frame_handler_mono.h:64).
Intrinsics are Python floats: they enter every op as scalars, so no camera
constant ever needs a host-to-device copy.

Conventions (as in the reference): ``world2cam`` maps a camera-frame point
to a distorted pixel (u, v); ``cam2world`` maps a pixel to a unit bearing.
"""

from __future__ import annotations

from typing import NamedTuple

import math
import re

import numpy as np
import torch


def _in_frame(cam, px: torch.Tensor, boundary: float, level: int):
    """Visibility mask at a pyramid level (ref: Frame::isInFrame)."""
    scale = float(2.0 ** level)
    w = cam.width / scale
    h = cam.height / scale
    u, v = px[..., 0], px[..., 1]
    return ((u >= boundary) & (u < w - boundary)
            & (v >= boundary) & (v < h - boundary))


class PinholeCamera(NamedTuple):
    """Pinhole camera with radial-tangential (OpenCV) distortion."""
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    width: float
    height: float

    @staticmethod
    def make(width, height, fx, fy, cx, cy,
             k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0) -> "PinholeCamera":
        """All-zero distortion returns the ideal subclass, as the JAX
        package does (its distortion math then drops out)."""
        vals = [float(v) for v in (fx, fy, cx, cy, k1, k2, p1, p2, k3,
                                   width, height)]
        ideal = all(v == 0.0 for v in vals[4:9])
        cls = PinholeCameraIdeal if ideal else PinholeCamera
        return cls(*vals)

    def _distort(self, xu: torch.Tensor) -> torch.Tensor:
        x, y = xu[..., 0], xu[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([xd, yd], dim=-1)

    def _undistort(self, xd: torch.Tensor) -> torch.Tensor:
        """Iterative inverse of _distort (10 division steps)."""
        xu = xd
        for _ in range(10):
            x, y = xu[..., 0], xu[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
            tx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            ty = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            radial = torch.where(torch.abs(radial) < 1e-6,
                                 torch.full_like(radial, 1e-6), radial)
            xu = torch.stack([(xd[..., 0] - tx) / radial,
                              (xd[..., 1] - ty) / radial], dim=-1)
        return xu

    def project_unitplane(self, uv: torch.Tensor) -> torch.Tensor:
        xd = self._distort(uv)
        return torch.stack([self.fx * xd[..., 0] + self.cx,
                            self.fy * xd[..., 1] + self.cy], dim=-1)

    def world2cam(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.project_unitplane(project2d(xyz))

    def cam2world(self, px: torch.Tensor) -> torch.Tensor:
        xd = torch.stack([(px[..., 0] - self.cx) / self.fx,
                          (px[..., 1] - self.cy) / self.fy], dim=-1)
        xu = self._undistort(xd)
        f = torch.cat([xu, torch.ones_like(xu[..., :1])], dim=-1)
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    def is_in_frame(self, px: torch.Tensor, boundary: float = 0.0,
                    level: int = 0) -> torch.Tensor:
        return _in_frame(self, px, boundary, level)

    @property
    def error_multiplier2(self) -> float:
        """Focal length for converting unit-plane errors to px (vikit)."""
        return self.fx


class PinholeCameraIdeal(PinholeCamera):
    """Distortion-free pinhole: _distort/_undistort are identities."""

    def _distort(self, xu: torch.Tensor) -> torch.Tensor:
        return xu

    def _undistort(self, xd: torch.Tensor) -> torch.Tensor:
        return xd


class ATANCamera(NamedTuple):
    """ATAN / FoV distortion camera (Devernay-Faugeras), as in vikit's
    ATANCamera (PTAM-style calibration; svo_ros/param/camera_atan.yaml)."""
    fx: float   # normalized focal * width, in px
    fy: float
    cx: float
    cy: float
    s: float    # FoV distortion parameter omega
    width: float
    height: float

    @staticmethod
    def make(width, height, fx, fy, cx, cy, s) -> "ATANCamera":
        """PTAM-style normalized intrinsics: scaled by the image size, with
        the half-pixel offset."""
        width, height = float(width), float(height)
        return ATANCamera(float(fx) * width, float(fy) * height,
                          float(cx) * width - 0.5, float(cy) * height - 0.5,
                          float(s), width, height)

    def _rd_factor(self, ru: torch.Tensor) -> torch.Tensor:
        """rd/ru factor for undistorted unit-plane radius ru."""
        if self.s < 1e-8:
            return torch.ones_like(ru)
        two_tan_half = 2.0 * math.tan(self.s * 0.5)
        small = ru < 1e-8
        safe = torch.where(small, torch.ones_like(ru), ru)
        fac = torch.atan(safe * two_tan_half) / (safe * self.s)
        return torch.where(small, torch.ones_like(fac), fac)

    def _ru_factor(self, rd: torch.Tensor) -> torch.Tensor:
        """ru/rd factor for distorted radius rd (closed-form inverse)."""
        if self.s < 1e-8:
            return torch.ones_like(rd)
        two_tan_half = 2.0 * math.tan(self.s * 0.5)
        small = rd < 1e-8
        safe = torch.where(small, torch.ones_like(rd), rd)
        fac = torch.tan(safe * self.s) / (safe * two_tan_half)
        return torch.where(small, torch.ones_like(fac), fac)

    def project_unitplane(self, uv: torch.Tensor) -> torch.Tensor:
        xd = uv * self._rd_factor(torch.linalg.vector_norm(uv, dim=-1))[
            ..., None]
        return torch.stack([self.fx * xd[..., 0] + self.cx,
                            self.fy * xd[..., 1] + self.cy], dim=-1)

    def world2cam(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.project_unitplane(project2d(xyz))

    def cam2world(self, px: torch.Tensor) -> torch.Tensor:
        xd = torch.stack([(px[..., 0] - self.cx) / self.fx,
                          (px[..., 1] - self.cy) / self.fy], dim=-1)
        rd = torch.linalg.vector_norm(xd, dim=-1)
        xu = xd * self._ru_factor(rd)[..., None]
        f = torch.cat([xu, torch.ones_like(xu[..., :1])], dim=-1)
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    def is_in_frame(self, px: torch.Tensor, boundary: float = 0.0,
                    level: int = 0) -> torch.Tensor:
        return _in_frame(self, px, boundary, level)

    @property
    def error_multiplier2(self) -> float:
        return self.fx


INV_POLY_LEN = 14       # the longest ocam world2cam polynomial


def _f32(v) -> float:
    return float(np.float32(v))


class OmniCamera(NamedTuple):
    """Omnidirectional (Scaramuzza Ocam) camera, vikit's omni_camera.

    Calibration in the ocam toolbox convention: ``poly`` (a0..a4) is the
    cam2world polynomial, the mirror-axis coordinate z_m of the ray at
    image radius rho (a0 < 0: z_m points into the mirror; the bearing
    flips it so forward points have z > 0); ``inv_poly`` (b0..b13) the
    world2cam polynomial rho(theta), theta = atan(z_m / rho_xy); the
    affine stretch [[c, d], [e, 1]] and the centre (xc, yc), xc the
    column.  The coefficients are float32 values zero-padded to their
    fixed lengths, as the JAX package keeps them."""
    poly: tuple       # 5 floats
    inv_poly: tuple   # INV_POLY_LEN floats
    xc: float
    yc: float
    c: float
    d: float
    e: float
    width: float
    height: float

    @staticmethod
    def make(width, height, poly, inv_poly, xc, yc,
             c=1.0, d=0.0, e=0.0) -> "OmniCamera":
        def padded(coeffs, n):
            coeffs = [_f32(v) for v in coeffs]
            return tuple(coeffs + [0.0] * (n - len(coeffs)))
        return OmniCamera(padded(poly, 5), padded(inv_poly, INV_POLY_LEN),
                          float(xc), float(yc), float(c), float(d), float(e),
                          float(width), float(height))

    @staticmethod
    def _polyval(coeffs, x: torch.Tensor) -> torch.Tensor:
        """Horner over the whole fixed-length coefficient tuple, highest
        first, as the JAX package evaluates it."""
        acc = torch.full_like(x, coeffs[-1])
        for k in range(len(coeffs) - 2, -1, -1):
            acc = acc * x + coeffs[k]
        return acc

    def world2cam(self, xyz: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3D (..., 3), z > 0 forward -> pixel (..., 2)."""
        x, y = xyz[..., 0], xyz[..., 1]
        z_m = -xyz[..., 2]                      # mirror-axis convention
        safe = torch.clamp(torch.sqrt(x * x + y * y), min=1e-10)
        rho = self._polyval(self.inv_poly, torch.atan2(z_m, safe))
        u = x / safe * rho
        v = y / safe * rho
        return torch.stack([self.c * u + self.d * v + self.xc,
                            self.e * u + v + self.yc], dim=-1)

    def cam2world(self, px: torch.Tensor) -> torch.Tensor:
        """Pixel (..., 2) -> unit bearing (..., 3), z > 0 forward."""
        du = px[..., 0] - self.xc
        dv = px[..., 1] - self.yc
        det = self.c - self.d * self.e
        det = 1e-10 if abs(det) < 1e-10 else det
        u = (du - self.d * dv) / det
        v = (-self.e * du + self.c * dv) / det
        z_m = self._polyval(self.poly, torch.sqrt(u * u + v * v))
        f = torch.stack([u, v, -z_m], dim=-1)   # flip to z-forward
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    def project_unitplane(self, uv: torch.Tensor) -> torch.Tensor:
        return self.world2cam(torch.cat([uv, torch.ones_like(uv[..., :1])],
                                        dim=-1))

    def is_in_frame(self, px: torch.Tensor, boundary: float = 0.0,
                    level: int = 0) -> torch.Tensor:
        return _in_frame(self, px, boundary, level)

    @property
    def fx(self) -> float:
        """Focal-length equivalent: |d rho / d phi| at the optical axis, phi
        the angle from the axis (vikit errorMultiplier).  The axis lies at
        theta = -pi/2 in the ocam angle convention, so this is the
        derivative of inv_poly there, not its first-order coefficient
        (2.5x off on the test calibration), in float32 as in JAX."""
        ip = np.asarray(self.inv_poly, np.float32)
        dcoef = ip[1:] * np.arange(1, len(ip), dtype=np.float32)
        x = np.float32(-np.pi / 2)
        acc = dcoef[-1]
        for k in range(len(dcoef) - 2, -1, -1):
            acc = np.float32(acc * x + dcoef[k])
        return float(abs(acc))

    @property
    def error_multiplier2(self) -> float:
        return self.fx


def load_ocam_calib(path: str) -> OmniCamera:
    """Parse a Scaramuzza ocam-toolbox ``calib_results.txt``.

    Sections in file order: the cam2world polynomial (count, then the
    coefficients), the world2cam polynomial, the centre (row then column,
    swapped into (xc, yc) here), the affine c, d, e, the image size
    (height, width)."""
    nums = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            nums.append([float(t) for t in re.findall(
                r"[-+0-9.eE]+", line) if t not in ("e", "E", ".")])
    rows = [r for r in nums if r]
    yc, xc = rows[2][0], rows[2][1]
    c, d, e = rows[3][:3]
    height, width = int(rows[4][0]), int(rows[4][1])
    return OmniCamera.make(width, height, rows[0][1:], rows[1][1:], xc, yc,
                           c, d, e)


def project2d(xyz: torch.Tensor) -> torch.Tensor:
    """3D -> unit-plane 2D (ref: vk::project2d)."""
    z = xyz[..., 2]
    zs = torch.where(torch.abs(z) < 1e-10, torch.full_like(z, 1e-10), z)
    return xyz[..., :2] / zs[..., None]
