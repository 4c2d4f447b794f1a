"""The port's stage ablations (``cfg.ablate``) against the JAX step's, on
the CPU.

``cfg.ablate`` stubs stages of the fused step out, for attributing a
step's time to its stages by differencing (tools_stage_timing.py).  Each
case runs JAX ``vo_step`` and the port's ``vo_step`` under the same
``cfg.ablate`` over frames 6 (a keyframe in the unablated run) and 7 of
the whole-step scene (tests/_torch_port.py, ``FULL_KW``), from the same
state: the port's own run after frame 5, converted to both packages.
Tolerances are the whole-step tests' of tests/test_torch_fused.py: 1e-5 m
after one step, 1e-4 after two, every discrete result exactly.  The JAX
step compiles once per case."""

import jax.numpy as jnp
import numpy as np
import pytest

from rpg_svo_tpu import config as jconfig
from rpg_svo_tpu.core import fused as jfused
from rpg_svo_tpu_torch import config as tconfig
from rpg_svo_tpu_torch.core import fused as tfused
from rpg_svo_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from rpg_svo_tpu_torch.geometry.se3 import SE3 as TSE3

from _torch_port import FULL_KW, SHAPE, jax_state, jax_tree, run_full, \
    to_torch
from test_torch_fused import _compare_full, _outs_equal

START = 5              # the cases track frames 6 and 7 from here
ONLY_PYR = ("align", "reproject", "pose", "struct", "df", "kf")


@pytest.fixture(scope="module")
def start():
    """The port's own state after frame START (fast), as numpy, and the
    images of the next two frames."""
    r = run_full("fast", 0)
    cfg = tconfig.fast_preset(**FULL_KW)
    Tfw = r["T0"].inverse()
    s = tfused.seed_first_frame_with_depth(
        to_torch(r["img0"]), TSE3(to_torch(Tfw.R), to_torch(Tfw.t)),
        to_torch(r["depth0"]), r["cam"], cfg, img_shape=SHAPE, device="cpu")
    imgs = [np.asarray(r["ds"].frame(i)[0]) for i in range(1, START + 3)]
    for img in imgs[:START]:
        s, _ = tfused.vo_step(s, to_torch(img), r["cam"], cfg, r["fh"].ncx,
                              r["fh"].ncy, SHAPE)
    return dict(r, tree=state_to_numpy(s), imgs=imgs[START:])


@pytest.mark.parametrize("ablate", [("align",), ("reproject",), ("pose",),
                                    ("struct",), ONLY_PYR],
                         ids=["align", "reproject", "pose", "struct",
                              "only_pyr"])
def test_ablated_steps_match_jax(start, ablate):
    r = start
    jcfg = jconfig.fast_preset(**FULL_KW).replace(ablate=ablate)
    tcfg = tconfig.fast_preset(**FULL_KW).replace(ablate=ablate)
    js = jax_state(r["tree"])
    ts = state_from_numpy(r["tree"], device="cpu")
    for img, atol in zip(r["imgs"], (1e-5, 1e-4)):
        js, jo = jfused.vo_step(js, jnp.asarray(img), r["ds"].cam, jcfg,
                                r["fh"].ncx, r["fh"].ncy, SHAPE)
        ts, to = tfused.vo_step(ts, to_torch(img), r["cam"], tcfg,
                                r["fh"].ncx, r["fh"].ncy, SHAPE)
        _outs_equal(to, jo, atol)
    _compare_full(state_to_numpy(ts), jax_tree(js), 1e-4)
