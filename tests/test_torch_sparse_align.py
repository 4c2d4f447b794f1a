"""Sparse image alignment of the port against the JAX package.

The port's level loop (_gn_loop, inside the plain twin of kernel K2) is
held against JAX _level_gn tightly (same operations; float32 sums of ~2000
terms in another order, amplified by the conditioning of the coarse
levels: 1e-4 m), and against the JAX Pallas kernel in interpret mode at
the bounds tests/test_pallas_align.py holds that kernel to against the XLA
loop (|dt| < 2e-3, |dR| < 2e-3, n_tracked +-3).  The whole coarse-to-fine
sparse_img_align, with and without robust weights, follows.

K2 (csrc/sparse_align.cu) reads the reference patches and the current
windows straight from the stacks.  A numpy spec of that addressing is held
bit-exact here against the plain twin's tile path (_precompute_level;
level_tiles + _window): both do the same float32 operations in the same
order, and a copy is exact.  The CUDA kernel itself is held against the
twin on the card in tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_svo_tpu.geometry.se3 import SE3 as JSE3
from rpg_svo_tpu.ops import pallas_align as jpa
from rpg_svo_tpu.ops import sparse_align as jsa
from rpg_svo_tpu.ops.detector import detect_features, grid_dims
from rpg_svo_tpu.ops.pallas_tiles import PaddedPyramid as JPad
from rpg_svo_tpu.ops.pyramid import build_pyramid
from rpg_svo_tpu.utils.synthetic import SyntheticDataset
from rpg_svo_tpu_torch.geometry.cameras import PinholeCameraIdeal
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3
from rpg_svo_tpu_torch.ops import align_kernel as tak
from rpg_svo_tpu_torch.ops import sparse_align as tsa
from rpg_svo_tpu_torch.ops.tiles import PaddedPyramid as TPad
from rpg_svo_tpu_torch.utils.synthetic import reference_test_camera

from _torch_port import to_torch

# the bench's 752x480: at the coarse alignment levels of a smaller image
# (15x20 px at level 4 of 240x320) the normal equations are near singular
# and any two summation orders take different first steps
SHAPE = (480, 752)


def _tse3(T):
    return TSE3(to_torch(T.R), to_torch(T.t))


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticDataset(n_frames=6, trajectory="circle", radius=0.3,
                          revolutions=0.1, shape=SHAPE)
    img0, depth0, T0 = ds.frame(0)
    img1, _, T1 = ds.frame(2)
    p0, p1 = build_pyramid(img0, 5), build_pyramid(img1, 5)
    jpad0, jpad1 = JPad(p0), JPad(p1)
    ncx, ncy = grid_dims(SHAPE[1], SHAPE[0], 25)
    feats = detect_features(p0[:3], jnp.zeros((ncx * ncy,), bool), 25)
    px = np.asarray(feats["px"])[:128]
    f = np.asarray(ds.cam.cam2world(jnp.asarray(px)))
    xi = np.clip(px[:, 0].astype(np.int32), 0, SHAPE[1] - 1)
    yi = np.clip(px[:, 1].astype(np.int32), 0, SHAPE[0] - 1)
    d = np.asarray(depth0)[yi, xi]
    valid = np.asarray(feats["valid"])[:128] & np.isfinite(d)
    d = np.where(np.isfinite(d), d, 1.0).astype(np.float32)
    tpad0 = TPad.from_stack(to_torch(jpad0.stack), jpad0.shapes)
    tpad1 = TPad.from_stack(to_torch(jpad1.stack), jpad1.shapes)
    tcam = reference_test_camera(SHAPE[1], SHAPE[0])
    T_gt = T1.inverse() * T0
    return dict(ds=ds, p0=p0, p1=p1, jpad0=jpad0, jpad1=jpad1, px=px, f=f,
                d=d, valid=valid, tpad0=tpad0, tpad1=tpad1, tcam=tcam,
                T_gt=T_gt)


def _level_inputs(s, level):
    jr = jsa._precompute_level(s["p0"][level], s["ds"].cam.fx,
                               jnp.asarray(s["px"]), jnp.asarray(s["f"]),
                               jnp.asarray(s["d"]), jnp.asarray(s["valid"]),
                               level, ref_pad=s["jpad0"])
    tr = tsa._precompute_level(s["tcam"].fx, to_torch(s["px"]),
                               to_torch(s["f"]), to_torch(s["d"]),
                               to_torch(s["valid"]), level, s["tpad0"])
    return jr, tr


@pytest.mark.parametrize("level", [4, 3, 2])
def test_precompute_level_matches(setup, level):
    jr, tr = _level_inputs(setup, level)
    np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]))
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), atol=1e-3)
    np.testing.assert_allclose(tr[1].numpy(), np.asarray(jr[1]), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("level", [4, 3, 2])
def test_level_gn_twin_matches_jax_level_gn(setup, level):
    """Same inputs (JAX's own reference patches and Jacobians) through JAX
    _level_gn (XLA, padded tiles) and the port's plain twin."""
    s = setup
    jr, _ = _level_inputs(s, level)
    p_ref = s["f"] * s["d"][:, None]
    T_init = JSE3.exp(jnp.asarray([0.004, -0.003, 0.002, 0.002, -0.001,
                                   0.003], jnp.float32))
    Tj, nj, Hj, cj = jsa._level_gn(s["p1"][level], s["ds"].cam, T_init,
                                   jnp.asarray(p_ref), *jr, level, 30, 1e-7,
                                   cur_pad=s["jpad1"])
    Tt, nt, Ht, ct, _ = tsa._level_gn(
        s["tcam"], _tse3(T_init), to_torch(p_ref), to_torch(jr[0]),
        to_torch(jr[1]), to_torch(jr[2]), level, 30, 1e-7, s["tpad1"])
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-4)
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-4)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("level", [4, 2])
def test_level_gn_twin_matches_pallas_kernel_interpret(setup, level):
    s = setup
    jr, _ = _level_inputs(s, level)
    p_ref = s["f"] * s["d"][:, None]
    T_init = JSE3.identity()
    Tj, nj, _, _ = jpa.level_gn_kernel(s["jpad1"], s["ds"].cam, T_init,
                                       jnp.asarray(p_ref), *jr, level, 30,
                                       1e-7, interpret=True)
    Tt, nt, _, _, _ = tsa._level_gn(s["tcam"], _tse3(T_init),
                                    to_torch(p_ref), to_torch(jr[0]),
                                    to_torch(jr[1]), to_torch(jr[2]), level,
                                    30, 1e-7, s["tpad1"])
    assert float(np.linalg.norm(Tt.t.numpy() - np.asarray(Tj.t))) < 2e-3
    assert float(np.abs(Tt.R.numpy() - np.asarray(Tj.R)).max()) < 2e-3
    assert abs(int(nt) // 16 - int(nj) // 16) <= 3


@pytest.mark.parametrize("robust", [False, True])
def test_sparse_img_align_matches_jax(setup, robust):
    s = setup
    args = (jnp.asarray(s["px"]), jnp.asarray(s["f"]), jnp.asarray(s["d"]),
            jnp.asarray(s["valid"]))
    rj = jsa.sparse_img_align(s["p0"], s["p1"], s["ds"].cam,
                              JSE3.identity(), *args, max_level=4,
                              min_level=2, cur_pad=s["jpad1"],
                              ref_pad=s["jpad0"], robust=robust,
                              use_kernel=False)
    rt = tsa.sparse_img_align(s["tpad0"], s["tpad1"], s["tcam"],
                              TSE3.identity(), to_torch(s["px"]),
                              to_torch(s["f"]), to_torch(s["d"]),
                              to_torch(s["valid"]), max_level=4, min_level=2,
                              robust=robust)
    np.testing.assert_allclose(rt.T_cur_ref.t.numpy(),
                               np.asarray(rj.T_cur_ref.t), atol=1e-4)
    np.testing.assert_allclose(rt.T_cur_ref.R.numpy(),
                               np.asarray(rj.T_cur_ref.R), atol=1e-4)
    assert int(rt.n_tracked) == int(rj.n_tracked)
    # and both track the ground truth
    err = np.linalg.norm(rt.T_cur_ref.t.numpy() - np.asarray(s["T_gt"].t))
    assert err < 0.02, err


def test_cpu_tensors_never_take_the_kernel(setup):
    s = setup
    assert not tak.use_align_kernel(s["tcam"], s["tpad1"], False)
    with pytest.raises(ValueError):
        tak.sparse_align_kernel(
            s["tpad0"], s["tpad1"], s["tcam"], TSE3.identity(),
            to_torch(s["px"]), to_torch(s["f"]), to_torch(s["d"]),
            to_torch(s["valid"]), 4, 2, 30, 1e-7)


# --- numpy spec of K2's stack-direct addressing ---------------------------

F32 = np.float32


def _spec_project(cam, R, t, p, scale):
    """world2cam(T p) * scale in float32, in geometry/cameras.py's order."""
    pc = [R[a, 0] * p[:, 0] + R[a, 1] * p[:, 1] + R[a, 2] * p[:, 2] + t[a]
          for a in range(3)]
    z = pc[2]
    zs = np.where(np.abs(z) < F32(1e-10), F32(1e-10), z)
    x, y = pc[0] / zs, pc[1] / zs
    if not isinstance(cam, PinholeCameraIdeal):
        k1, k2, k3 = F32(cam.k1), F32(cam.k2), F32(cam.k3)
        r2 = x * x + y * y
        radial = F32(1.0) + r2 * (k1 + r2 * (k2 + r2 * k3))
        x, y = (x * radial + F32(2.0 * cam.p1) * x * y
                + F32(cam.p2) * (r2 + F32(2.0) * x * x),
                y * radial + F32(cam.p1) * (r2 + F32(2.0) * y * y)
                + F32(2.0 * cam.p2) * x * y)
    u = (F32(cam.fx) * x + F32(cam.cx)) * F32(scale)
    v = (F32(cam.fy) * y + F32(cam.cy)) * F32(scale)
    return u, v


def _spec_level(pad, level):
    tab = pad.kernel_table()
    return tab.w[level], tab.h[level], tab.off[level]


def _spec_tile_origin(pad, cam, R0, t0, p, level):
    """K2's clamped 17x17 tile origin at the level's starting pose."""
    W, H, _ = _spec_level(pad, level)
    u, v = _spec_project(cam, R0, t0, p, 1.0 / 2 ** level)
    bx = np.floor(u).astype(np.int32) - 8
    by = np.floor(v).astype(np.int32) - 8
    return (np.clip(bx, 0, max(W - 17, 0)).astype(np.int32),
            np.clip(by, 0, max(H - 17, 0)).astype(np.int32), bx, by)


def _spec_window(pad, cam, R, t, p, level, x0c, y0c):
    """K2's bilinear 4x4 window at pose T, read straight from the stack at
    (first row + y0c + iy + py, x0c + ix + px): (vals (N, 16), usable)."""
    stack = pad.stack.numpy()
    _, _, off = _spec_level(pad, level)
    u, v = _spec_project(cam, R, t, p, 1.0 / 2 ** level)
    ox = u - F32(2.0) - x0c.astype(F32)
    oy = v - F32(2.0) - y0c.astype(F32)
    oxf, oyf = np.floor(ox), np.floor(oy)
    wx, wy = ox - oxf, oy - oyf
    usable = (oxf >= 0) & (oyf >= 0) & (oxf <= 12) & (oyf <= 12)
    vals = np.zeros((p.shape[0], 16), F32)
    for i in np.flatnonzero(usable):
        for py in range(4):
            for px in range(4):
                r = off + y0c[i] + int(oyf[i]) + py
                c = x0c[i] + int(oxf[i]) + px
                c0 = (F32(1.0) - wy[i]) * stack[r, c] + wy[i] * stack[r + 1, c]
                c1 = (F32(1.0) - wy[i]) * stack[r, c + 1] \
                    + wy[i] * stack[r + 1, c + 1]
                vals[i, 4 * py + px] = (F32(1.0) - wx[i]) * c0 + wx[i] * c1
    return vals, usable


def _spec_ref_patch(pad, fx, px, f, depth, valid, level):
    """K2's prologue: reference patch, IC Jacobian and validity read from
    the reference stack (8x8 origin clamped into the level)."""
    stack = pad.stack.numpy()
    W, H, off = _spec_level(pad, level)
    scale = F32(1.0 / 2 ** level)
    uv = px * scale
    fl = np.floor(uv).astype(np.int32)
    want = fl - 3
    xc = np.clip(want[:, 0], 0, max(W - 8, 0))
    yc = np.clip(want[:, 1], 0, max(H - 8, 0))
    okb = (xc == want[:, 0]) & (yc == want[:, 1])
    frac = uv - fl.astype(F32)
    wx, wy = frac[:, 0], frac[:, 1]
    w00, w01 = (F32(1) - wy) * (F32(1) - wx), (F32(1) - wy) * wx
    w10, w11 = wy * (F32(1) - wx), wy * wx
    n = px.shape[0]
    pb = np.zeros((n, 6, 6), F32)
    for i in range(6):
        for j in range(6):
            r, c = off + yc + i, xc + j
            pb[:, i, j] = (w00 * stack[r, c] + w01 * stack[r, c + 1]
                           + w10 * stack[r + 1, c]
                           + w11 * stack[r + 1, c + 1])
    vals = pb[:, 1:5, 1:5].reshape(n, 16)
    dx = (F32(0.5) * (pb[:, 1:5, 2:6] - pb[:, 1:5, 0:4])).reshape(n, 16)
    dy = (F32(0.5) * (pb[:, 2:6, 1:5] - pb[:, 0:4, 1:5])).reshape(n, 16)
    p = f * depth[:, None]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    zi = F32(1.0) / np.where(np.abs(z) < F32(1e-10), F32(1e-10), z)
    zi2 = zi * zi
    zero = np.zeros_like(x)
    j0 = np.stack([-zi, zero, x * zi2, y * x * zi2,
                   -(F32(1.0) + x * x * zi2), y * zi], -1)
    j1 = np.stack([zero, -zi, y * zi2, F32(1.0) + y * y * zi2,
                   -x * y * zi2, -x * zi], -1)
    jac = (dx[..., None] * j0[:, None, :] + dy[..., None] * j1[:, None, :]) \
        * F32(fx * scale)
    return vals, jac, valid & (depth > F32(1e-6)) & okb


def _edge_points(cam, n, seed):
    """Points whose projections spread over and past every image edge."""
    rng = np.random.default_rng(seed)
    px = np.stack([rng.uniform(-120, cam.width + 120, n),
                   rng.uniform(-120, cam.height + 120, n)], -1)
    b = np.stack([(px[:, 0] - cam.cx) / cam.fx, (px[:, 1] - cam.cy) / cam.fy,
                  np.ones(n)], -1)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    return (b * rng.uniform(1.0, 6.0, n)[:, None]).astype(F32)


def _pose(rng, sd_t, sd_r):
    xi = rng.normal(0, [sd_t] * 3 + [sd_r] * 3)
    return TSE3.exp(torch.tensor(xi, dtype=torch.float32))


@pytest.mark.parametrize("distorted", [False, True])
@pytest.mark.parametrize("level", [4, 3, 2])
def test_stack_direct_window_spec_bit_exact(setup, level, distorted):
    """K2's addressing (tile origin from the pose, clamp against the level
    table, window read from the stack) equals level_tiles + _window bit
    for bit, at seeded poses whose tiles clamp at every edge."""
    s = setup
    cam = s["tcam"]
    if distorted:
        cam = type(cam).make(cam.width, cam.height, cam.fx, cam.fy, cam.cx,
                             cam.cy, -0.28, 0.07, 1e-4, -2e-4, 0.0)
    rng = np.random.default_rng(10 * level + distorted)
    p = _edge_points(cam, 600, level)
    pad = s["tpad1"]
    W, H, _ = _spec_level(pad, level)
    edges = set()
    for _ in range(3):
        T0 = _pose(rng, 0.05, 0.03)
        T = T0 * _pose(rng, 0.01 * 2 ** (level - 2), 0.006 * 2 ** (level - 2))
        x0c, y0c, bx, by = _spec_tile_origin(pad, cam, T0.R.numpy(),
                                             T0.t.numpy(), p, level)
        edges |= {k for k, hit in (("left", bx < 0), ("top", by < 0),
                                   ("right", bx > W - 17),
                                   ("bottom", by > H - 17)) if hit.any()}
        tl, xt, yt = tak.level_tiles(pad, cam, T0, torch.from_numpy(p),
                                     level)
        np.testing.assert_array_equal(xt.numpy(), x0c)
        np.testing.assert_array_equal(yt.numpy(), y0c)
        vals, usable = _spec_window(pad, cam, T.R.numpy(), T.t.numpy(), p,
                                    level, x0c, y0c)
        base = torch.stack([xt, yt], -1).to(torch.float32)
        uv = cam.world2cam(T.apply(torch.from_numpy(p))) / 2 ** level
        tv, tu = tsa._window(tl, uv - 2 - base)
        np.testing.assert_array_equal(tu.numpy(), usable)
        assert usable.any() and not usable.all()
        np.testing.assert_array_equal(tv.numpy()[usable], vals[usable])
    assert edges == {"left", "top", "right", "bottom"}, edges


@pytest.mark.parametrize("level", [4, 3, 2])
def test_stack_direct_ref_patch_spec_bit_exact(setup, level):
    """K2's prologue (reference patch, Jacobian, validity read from the
    reference stack) equals _precompute_level bit for bit, for the
    detected features and for features past every edge of the level."""
    s = setup
    rng = np.random.default_rng(level)
    n = 200
    px = np.concatenate([s["px"], np.stack(
        [rng.uniform(-30, SHAPE[1] + 30, n),
         rng.uniform(-30, SHAPE[0] + 30, n)], -1).astype(F32)])
    f = np.concatenate([s["f"], np.tile(s["f"][:1], (n, 1))])
    d = np.concatenate([s["d"], rng.uniform(-0.5, 5.0, n).astype(F32)])
    valid = np.concatenate([s["valid"], rng.uniform(size=n) < 0.8])
    vals, jac, ok = _spec_ref_patch(s["tpad0"], s["tcam"].fx, px, f, d,
                                    valid, level)
    tv, tj, tok = tsa._precompute_level(
        s["tcam"].fx, torch.from_numpy(px), torch.from_numpy(f),
        torch.from_numpy(d), torch.from_numpy(valid), level, s["tpad0"])
    np.testing.assert_array_equal(tok.numpy(), ok)
    assert ok.any() and not ok.all()
    np.testing.assert_array_equal(tv.numpy(), vals)
    np.testing.assert_array_equal(tj.numpy(), jac)
