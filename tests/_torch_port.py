"""Shared helpers of the tests that hold rpg_svo_tpu_torch against the JAX
package: state conversion to nested numpy dicts, the small scene both
packages render, and the card check of the CUDA-marked tests."""

from __future__ import annotations

import numpy as np
import pytest
import torch

# the port's CPU tests run small tensors op by op: one intra-op thread is
# as fast, and the suite's parallel workers do not oversubscribe the cores
torch.set_num_threads(1)

# small scene of the port tests: 240x320 keeps the JAX CPU compiles short;
# grid 12 gives 27x20 = 540 cells, more than the 256-cell attempt budget,
# so the reprojector's budgeted selection runs as in the 752x480 bench
SHAPE = (240, 320)
CFG_KW = dict(grid_size=12, max_points=2048, max_kfs_pool=4, max_seeds=128,
              ablate=("kf", "df"))
# the whole step (ablate=()) on the small scene: the bench's epipolar scan
# (32/8 steps, 4 rows), a 128-seed pool updated 96 at a time (the
# compacted path), and a keyframe every 3-4 frames (kfselect 0.08) into a
# 6-slot pool capped at 4 keyframes, so that within 18 frames keyframes
# are inserted, seeds are updated and converge into candidates, and the
# map cap deletes keyframes
FULL_KW = dict(grid_size=12, max_points=2048, max_kfs_pool=6, max_seeds=128,
               max_n_kfs=4, kfselect_mindist=0.08, df_update_k=96,
               epi_max_steps=32, epi_short_steps=8, epi_scan_rows=4)
# the scene of the whole-step tests: twice the angular speed of the
# slice-A scene
FULL_SCENE = dict(n_frames=36, trajectory="circle", radius=0.25,
                  revolutions=0.9, shape=SHAPE)
FULL_FRAMES = 18


def jax_tree(x):
    """A JAX pytree of NamedTuples (and PaddedPyramids) as nested dicts of
    numpy arrays, the layout core/convert.state_from_numpy reads."""
    if hasattr(x, "_asdict"):
        return {k: jax_tree(v) for k, v in x._asdict().items()}
    if hasattr(x, "stack") and hasattr(x, "shapes"):
        return {"stack": np.array(x.stack),
                "shapes": [list(s) for s in x.shapes]}
    return np.array(x)


def to_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def jax_state(tree):
    """The JAX package's VOState from nested dicts of numpy arrays (the
    layout of core/convert.state_to_numpy)."""
    import jax.numpy as jnp
    from rpg_svo_tpu.core import fused as jfused
    from rpg_svo_tpu.core import map as jmap
    from rpg_svo_tpu.ops.pallas_tiles import PaddedPyramid

    def nt(cls, d):
        return cls(**{k: jnp.asarray(d[k]) for k in cls._fields})
    m = tree["m"]
    mapstate = jmap.MapState(nt(jmap.KeyframeStore, m["kf"]),
                             nt(jmap.PointStore, m["pt"]),
                             nt(jmap.SeedStore, m["seed"]),
                             jnp.asarray(m["kf_counter"]))
    pad = PaddedPyramid.from_stack(jnp.asarray(tree["pad"]["stack"]),
                                   tree["pad"]["shapes"])
    return jfused.VOState(m=mapstate, pad=pad, **{
        k: jnp.asarray(tree[k]) for k in jfused.VOState._fields
        if k not in ("m", "pad")})


def run_full(preset: str, n_frames: int = FULL_FRAMES, jax_steps=True):
    """The whole-step scene (JAX renderer), seeded by the port's
    seed_first_frame_with_depth on the CPU (its agreement with
    FrameHandler is tests/test_torch_fused.py's), then n_frames steps of
    the JAX fused step (jax_steps) or of the port's.  Returns a dict with
    the dataset, both configs, the grid (fh.ncx, fh.ncy), the numpy images
    of frames 1..n, the states as JAX VOStates (index i: after frame i)
    and the step outputs, and the port's camera."""
    import types

    import jax.numpy as jnp
    from rpg_svo_tpu import config as jconfig
    from rpg_svo_tpu.core import fused as jfused
    from rpg_svo_tpu.utils.synthetic import SyntheticDataset
    from rpg_svo_tpu_torch import config as tconfig
    from rpg_svo_tpu_torch.core import fused as tfused
    from rpg_svo_tpu_torch.core.convert import state_to_numpy
    from rpg_svo_tpu_torch.geometry.se3 import SE3
    from rpg_svo_tpu_torch.ops.detector import grid_dims
    from rpg_svo_tpu_torch.utils.synthetic import reference_test_camera
    ds = SyntheticDataset(**FULL_SCENE)
    jcfg = getattr(jconfig, f"{preset}_preset")(**FULL_KW)
    tcfg = getattr(tconfig, f"{preset}_preset")(**FULL_KW)
    cam = reference_test_camera(SHAPE[1], SHAPE[0])
    fh = types.SimpleNamespace(
        **dict(zip(("ncx", "ncy"), grid_dims(SHAPE[1], SHAPE[0],
                                             tcfg.grid_size))))
    img0, depth0, T0 = ds.frame(0)
    Tfw = T0.inverse()
    ts = tfused.seed_first_frame_with_depth(
        to_torch(img0), SE3(to_torch(Tfw.R), to_torch(Tfw.t)),
        to_torch(depth0), cam, tcfg, img_shape=SHAPE, device="cpu")
    states = [jax_state(state_to_numpy(ts))]
    outs = []
    imgs = [np.asarray(ds.frame(i)[0]) for i in range(1, n_frames + 1)]
    for img in imgs:
        if jax_steps:
            js, out = jfused.vo_step(states[-1], jnp.asarray(img), ds.cam,
                                     jcfg, fh.ncx, fh.ncy, SHAPE)
        else:
            ts, out = tfused.vo_step(ts, to_torch(img), cam, tcfg, fh.ncx,
                                     fh.ncy, SHAPE)
            js = jax_state(state_to_numpy(ts))
        states.append(js)
        outs.append(out)
    return dict(ds=ds, jcfg=jcfg, tcfg=tcfg, fh=fh, imgs=imgs, T0=T0,
                img0=np.asarray(img0), depth0=np.asarray(depth0),
                states=states, outs=outs, cam=cam)


def close(a, b, name, atol, rtol=None):
    """Integer and bool arrays exactly; floats to atol with rtol = atol/10
    unless given."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, atol=atol,
                                   rtol=atol / 10 if rtol is None else rtol,
                                   err_msg=name)


def need_cuda() -> torch.device:
    """The card for a CUDA-marked test; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the chip")
    return torch.device("cuda")
