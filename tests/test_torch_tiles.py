"""The port's tile gather (kernel K1's plain twin on the CPU) against the JAX
package's gather_tiles, its XLA fallback and its Pallas kernel in interpret
mode: bit-exact, because a gather only copies.  Mirrors
tests/test_pallas_tiles.py, including the clamping case; plus the flat
per-item-level samplers and the creation-time tiles.  The kernel itself
is held against the twin on the card in tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_svo_tpu.ops import patches as jpatch
from rpg_svo_tpu.ops.interp import FlatPyramid as JFlat
from rpg_svo_tpu.ops.pallas_tiles import PaddedPyramid as JPad
from rpg_svo_tpu.ops.pallas_tiles import gather_tiles as jgather
from rpg_svo_tpu.ops.pallas_tiles import padded_layout as jlayout
from rpg_svo_tpu.ops.pyramid import build_pyramid
from rpg_svo_tpu_torch.ops import patches as tpatch
from rpg_svo_tpu_torch.ops import tiles as ttiles

from _torch_port import to_torch


@pytest.fixture(scope="module")
def pyr():
    img = np.random.default_rng(0).uniform(0, 255, (480, 752)) \
        .astype(np.float32)
    levels = build_pyramid(jnp.asarray(img), 5)
    jp = JPad(levels)
    tp = ttiles.PaddedPyramid.from_stack(to_torch(jp.stack), jp.shapes)
    return levels, jp, tp


def _items(n, seed):
    rng = np.random.default_rng(seed)
    level = rng.integers(0, 5, n).astype(np.int32)
    # random origins, some intentionally out of range (clamped)
    x0 = rng.integers(-10, 760, n).astype(np.int32)
    y0 = rng.integers(-10, 470, n).astype(np.int32)
    return level, x0, y0


@pytest.mark.parametrize("th,tw", [(17, 17), (24, 24), (8, 8)])
@pytest.mark.parametrize("interpret", [False, True])
def test_gather_tiles_bit_exact_with_jax(pyr, th, tw, interpret):
    _, jp, tp = pyr
    level, x0, y0 = _items(37, th)
    tj, xj, yj = jgather(jp, jnp.asarray(level), jnp.asarray(x0),
                         jnp.asarray(y0), th, tw, interpret=interpret)
    tt, xt, yt = ttiles.gather_tiles(tp, to_torch(level), to_torch(x0),
                                     to_torch(y0), th, tw)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert xt.dtype == yt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_clamping_keeps_tiles_in_level(pyr):
    levels, _, tp = pyr
    level = to_torch(np.array([4, 4], np.int32))      # 30 x 47 level
    x0 = to_torch(np.array([100, -5], np.int32))
    y0 = to_torch(np.array([100, -5], np.int32))
    tiles, x0c, y0c = ttiles.gather_tiles(tp, level, x0, y0, 17, 17)
    assert int(x0c[0]) == 47 - 17 and int(y0c[0]) == 30 - 17
    assert int(x0c[1]) == 0 and int(y0c[1]) == 0
    lv4 = np.asarray(levels[4])
    np.testing.assert_array_equal(tiles[0].numpy(), lv4[13:30, 30:47])
    np.testing.assert_array_equal(tiles[1].numpy(), lv4[:17, :17])


@pytest.mark.parametrize("shape", [(480, 752), (240, 320), (120, 160),
                                   (61, 97)])
def test_padded_layout_matches(shape):
    from rpg_svo_tpu.ops.pyramid import pyramid_shapes
    shapes = pyramid_shapes(shape, 5)
    Wj, Hj, oj = jlayout(shapes)
    Wt, Ht, ot = ttiles.padded_layout(shapes)
    assert (Wt, Ht) == (Wj, Hj)
    np.testing.assert_array_equal(ot, oj)


def test_from_levels_and_roundtrip(pyr):
    levels, jp, tp = pyr
    built = ttiles.PaddedPyramid.from_levels(
        [to_torch(np.asarray(l)) for l in levels])
    np.testing.assert_array_equal(built.stack.numpy(), np.asarray(jp.stack))
    for a, b in zip(tp.levels(), levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    again = ttiles.PaddedPyramid.from_stack(tp.stack.reshape(-1), tp.shapes)
    assert again.stack.shape == tp.stack.shape


def test_flat_view_samplers_match_jax(pyr):
    """The strided flat view samples as the JAX one (bilinear + nearest,
    validity included)."""
    _, jp, tp = pyr
    rng = np.random.default_rng(3)
    n = 257
    lv = rng.integers(0, 5, n).astype(np.int32)
    xy = (rng.uniform(size=(n, 2)) * [900.0, 600.0] - 50.0) \
        .astype(np.float32)
    xy[:5] = np.round(xy[:5]) + 0.5        # round-half-to-even cases
    jf = JFlat.from_padded(jp)
    tf = tp.flat_view()
    vb1, ok1 = jf.bilinear(jnp.asarray(lv), jnp.asarray(xy))
    vb2, ok2 = tf.bilinear(to_torch(lv), to_torch(xy))
    np.testing.assert_array_equal(ok2.numpy(), np.asarray(ok1))
    np.testing.assert_allclose(vb2.numpy(), np.asarray(vb1), atol=1e-4)
    vn1, okn1 = jf.nearest(jnp.asarray(lv), jnp.asarray(xy))
    vn2, okn2 = tf.nearest(to_torch(lv), to_torch(xy))
    np.testing.assert_array_equal(okn2.numpy(), np.asarray(okn1))
    np.testing.assert_array_equal(vn2.numpy(), np.asarray(vn1))


def test_extract_and_sample_tiles_match_jax(pyr):
    """Creation-time 24x24 tiles (bit-exact) and their bilinear resampling
    (interpolation in another summation order: 1e-3 of 255)."""
    _, jp, tp = pyr
    rng = np.random.default_rng(5)
    n = 64
    px = (rng.uniform(size=(n, 2)) * [760.0, 490.0] - 4.0).astype(np.float32)
    lv = rng.integers(0, 3, n).astype(np.int32)
    tj, xyj = jpatch.extract_tiles(jp, jnp.asarray(px), jnp.asarray(lv))
    tt, xyt = tpatch.extract_tiles(tp, to_torch(px), to_torch(lv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(xyt.numpy(), np.asarray(xyj))
    xy0 = np.asarray(xyj).copy()
    xy0[:3] = -1                           # items without a tile
    coords = (xy0[:, None, :] + rng.uniform(-2, 26, (n, 100, 2))) \
        .astype(np.float32)
    vj, okj = jpatch.sample_tiles(tj, jnp.asarray(xy0), jnp.asarray(coords))
    vt, okt = tpatch.sample_tiles(tt, to_torch(xy0), to_torch(coords))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-3)
    w = rng.uniform(size=50).astype(np.float32)
    for a, b in zip(tpatch.catmull_rom_weights(to_torch(w)),
                    jpatch.catmull_rom_weights(jnp.asarray(w))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


def test_wrapper_refuses_a_cpu_tensor_for_the_kernel(pyr):
    _, _, tp = pyr
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ttiles.tile_gather_kernel(tp, z, z, z, 17, 17)



def test_image_bilinear_and_patch_grid_match_jax(pyr):
    from rpg_svo_tpu.ops import interp as jinterp
    from rpg_svo_tpu_torch.ops import interp as tinterp
    levels, _, _ = pyr
    img = np.asarray(levels[1])
    xy = (np.random.default_rng(9).uniform(size=(300, 2))
          * [400.0, 260.0] - 8.0).astype(np.float32)
    vj, okj = jinterp.bilinear(jnp.asarray(img), jnp.asarray(xy))
    vt, okt = tinterp.bilinear(to_torch(img), to_torch(xy))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-3)
    for half, border in ((2, 1), (4, 0)):
        np.testing.assert_array_equal(
            tinterp.patch_grid(half, border).numpy(),
            np.asarray(jinterp.patch_grid(half, border)))
