"""The port's offline benchmark driver (rpg_svo_tpu_torch/tools/
benchmark.py) against the JAX package's on the CPU.

The blender protocol on a 10-frame tree at 752x480 (the scene of
tests/test_blender_benchmark.py:102-130: ground-truth depth seeding,
noise sigma 1 drawn on the host from the same seed, per-frame error
traces, depth errors, PLY) and the experiment YAML of
tests/test_blender_benchmark.py:132-180, each run once by both drivers:
equal stages and results per frame, trajectories within 1e-4 m, equal
report keys, ATE within 10%.  The file datasets (TUM, EuRoC) and the
synthetic one run through the port's driver alone: the JAX driver's file
iterator names jnp without importing it (NameError, recorded below)."""

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from rpg_svo_tpu.core.pipeline import FrameHandler as JFrameHandler
from rpg_svo_tpu.tools import benchmark as jbench
from rpg_svo_tpu_torch.core.pipeline import FrameHandler as TFrameHandler
from rpg_svo_tpu_torch.geometry.se3 import rot_to_quat
from rpg_svo_tpu_torch.tools import benchmark as tbench
from rpg_svo_tpu_torch.utils.synthetic import SyntheticDataset

ROOT = Path(__file__).resolve().parent.parent
OUTPUTS = ("traj_estimate.txt", "trace.csv", "translation_error.txt",
           "orientation_error.txt", "map_points.ply", "report.json")


@contextlib.contextmanager
def recording(cls):
    """Record the info dict of every add_image call of a FrameHandler
    class."""
    infos = []
    orig = cls.add_image

    def add_image(self, img, timestamp=0.0):
        info = orig(self, img, timestamp)
        infos.append(dict(info))
        return info
    cls.add_image = add_image
    try:
        yield infos
    finally:
        cls.add_image = orig


def _blender_tree(root, n, revolutions, shape=(480, 752)):
    ds = SyntheticDataset(n_frames=n, trajectory="circle", radius=0.25,
                          revolutions=revolutions, shape=shape, device="cpu")
    imgs, depths = [], {}
    for i in range(n):
        img, depth, _ = ds.frame(i)
        imgs.append(chip_smoke.to_u8(img.numpy()))
        depths[i] = depth.numpy()
    t = np.stack([p.t.numpy() for p in ds.poses])
    q = np.stack([rot_to_quat(p.R).numpy() for p in ds.poses])
    chip_smoke.write_blender(root, imgs, t, q, depths)
    return imgs, t, q


def _args(**kw):
    base = dict(experiment=None, dataset_dir=None, dataset="blender",
                path=None, out=None, frames=10, preset="fast", grid_size=25,
                cam="315.5,315.5,376.0,240.0", seed_first_frame=True,
                verbose=False, noise_sigma=1.0, noise_seed=0,
                trace_depth=True, ply=True, min_fts=0)
    base.update(kw)
    return argparse.Namespace(**base)


def _run_both(fn, make_args, tmp):
    """fn(args) of both drivers, recording each handler's frames."""
    out = {}
    for name, mod, cls, extra in (("jax", jbench, JFrameHandler, {}),
                                  ("port", tbench, TFrameHandler,
                                   {"device": "cpu"})):
        with recording(cls) as infos:
            res = getattr(mod, fn)(make_args(out=str(tmp / name), **extra))
        out[name] = (res, infos, tmp / name)
    return out


@pytest.fixture(scope="module")
def blender_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("blender")
    _blender_tree(tmp / "blender_ds", 10, 0.125)
    return _run_both("run", lambda **kw: _args(path=str(tmp / "blender_ds"),
                                               **kw), tmp)


def _same_frames(tinfos, jinfos):
    assert len(tinfos) == len(jinfos) > 0
    for i, (t, j) in enumerate(zip(tinfos, jinfos)):
        assert (t["stage"], t["result"]) == (j["stage"], j["result"]), i
        assert bool(t.get("is_keyframe")) == bool(j.get("is_keyframe")), i


def _same_trajectory(tdir, jdir):
    t = np.loadtxt(tdir / "traj_estimate.txt")
    j = np.loadtxt(jdir / "traj_estimate.txt")
    assert t.shape == j.shape
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1:4], j[:, 1:4], atol=1e-4)
    np.testing.assert_allclose(t[:, 4:], j[:, 4:], atol=1e-3)


def _same_reports(t, j):
    assert t.keys() == j.keys()
    for k in ("ate", "rpe_delta1", "depth_error"):
        if k in j:
            assert t[k].keys() == j[k].keys(), k
    assert t["frames"] == j["frames"]
    assert t["ate"]["n"] == j["ate"]["n"]
    assert t["ate"]["rmse"] == pytest.approx(j["ate"]["rmse"], rel=0.1)


def test_blender_driver_matches_jax(blender_runs):
    (jrep, jinfos, jdir), (trep, tinfos, tdir) = blender_runs["jax"], \
        blender_runs["port"]
    _same_frames(tinfos, jinfos)
    _same_trajectory(tdir, jdir)
    _same_reports(trep, jrep)
    assert trep["frames"] == 9 and trep["ate"]["rmse"] < 0.05
    assert trep["depth_error"]["n"] == jrep["depth_error"]["n"] > 0
    assert trep["depth_error"]["p50"] == pytest.approx(
        jrep["depth_error"]["p50"], rel=0.1)
    assert trep["rpe_delta1"]["n"] == jrep["rpe_delta1"]["n"]
    assert json.loads((tdir / "report.json").read_text()).keys() == \
        json.loads((jdir / "report.json").read_text()).keys()


def test_blender_driver_writes_the_jax_drivers_files(blender_runs):
    jdir, tdir = blender_runs["jax"][2], blender_runs["port"][2]
    got = sorted(os.listdir(tdir))
    assert got == sorted(os.listdir(jdir))
    assert set(OUTPUTS) | {"depth_error.txt"} <= set(got)
    # the orientation error is arccos of a float32 trace, which resolves
    # steps of 4.9e-4 rad near zero in both packages
    for name, atol in (("translation_error.txt", 1e-4),
                       ("orientation_error.txt", 1e-3)):
        t, j = np.loadtxt(tdir / name), np.loadtxt(jdir / name)
        assert t.shape == j.shape
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
        np.testing.assert_allclose(t[:, 1:], j[:, 1:], atol=atol)
    t = (tdir / "trace.csv").read_text().splitlines()
    j = (jdir / "trace.csv").read_text().splitlines()
    assert t[0] == j[0] and len(t) == len(j)
    tp = (tdir / "map_points.ply").read_text().splitlines()
    jp = (jdir / "map_points.ply").read_text().splitlines()
    assert tp[:8] == jp[:8]
    np.testing.assert_allclose(np.loadtxt(tp[8:]), np.loadtxt(jp[8:]),
                               atol=2e-3)


@pytest.fixture(scope="module")
def experiment_runs(tmp_path_factory):
    """tests/test_blender_benchmark.py:132-180's experiment: the algorithm
    YAML overrides the grid, the keyframe cap and local BA; the dataset's
    params give the pinhole camera."""
    tmp = tmp_path_factory.mktemp("experiment")
    _blender_tree(tmp / "blender_ds", 8, 0.1)
    (tmp / "blender_ds" / "dataset_params.yaml").write_text(
        "dataset_is_blender: True\ncam0:\n  cam_model: Pinhole\n"
        "  cam_width: 752\n  cam_height: 480\n  cam_fx: 315.5\n"
        "  cam_fy: 315.5\n  cam_cx: 376.0\n  cam_cy: 240.0\n")
    (tmp / "vo_custom.yaml").write_text(
        "grid_size: 30\nmax_n_kfs: 10\nloba_num_iter: 0\n")
    (tmp / "exp.yaml").write_text(
        "experiment_label: 'svo test'\nparam_settings: vo_custom\n"
        "dataset: blender_ds\n")
    return _run_both("run_experiment", lambda **kw: _args(
        experiment=str(tmp / "exp.yaml"), dataset_dir=str(tmp),
        dataset="synthetic", frames=8, cam=None, noise_sigma=0.0,
        trace_depth=False, ply=False, **kw), tmp)


def test_experiment_driver_matches_jax(experiment_runs):
    (jrep, jinfos, jdir), (trep, tinfos, tdir) = experiment_runs["jax"], \
        experiment_runs["port"]
    assert trep.keys() == jrep.keys() == {"blender_ds"}
    _same_frames(tinfos, jinfos)
    _same_reports(trep["blender_ds"], jrep["blender_ds"])
    _same_trajectory(tdir / "svo_test_blender_ds", jdir / "svo_test_blender_ds")
    assert trep["blender_ds"]["ate"]["rmse"] < 0.05
    t = json.loads((tdir / "experiment_report.json").read_text())
    j = json.loads((jdir / "experiment_report.json").read_text())
    assert t["label"] == j["label"] == "svo test"
    assert t["datasets"]["blender_ds"].keys() == \
        j["datasets"]["blender_ds"].keys()


def _file_trees(tmp, n=12, shape=(240, 320)):
    ds = SyntheticDataset(n_frames=n, trajectory="circle", radius=0.25,
                          revolutions=0.1, shape=shape, device="cpu")
    imgs = [chip_smoke.to_u8(ds.frame(i)[0].numpy()) for i in range(n)]
    t = np.stack([p.t.numpy() for p in ds.poses])
    q = np.stack([rot_to_quat(p.R).numpy() for p in ds.poses])
    chip_smoke.write_euroc(tmp / "euroc", list(range(n)), imgs, t, q)
    tum = tmp / "tum"
    (tum / "rgb").mkdir(parents=True)
    rows, gt = [], []
    for i, img in enumerate(imgs):
        chip_smoke.write_pgm(tum / "rgb" / f"{i:03d}.pgm", img)
        rows.append(f"{i / 50.0:.6f} rgb/{i:03d}.pgm")
        gt.append(f"{i / 50.0:.6f} " + " ".join(map(str, (*t[i], *q[i]))))
    (tum / "rgb.txt").write_text("\n".join(rows) + "\n")
    (tum / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    return imgs


@pytest.mark.parametrize("dataset", ["tum", "euroc"])
def test_file_dataset_runs_through_the_ports_driver(tmp_path, dataset,
                                                    capsys):
    imgs = _file_trees(tmp_path)
    with recording(TFrameHandler) as infos:
        rep = tbench.run(_args(dataset=dataset, path=str(tmp_path / dataset),
                               out=str(tmp_path / "out"), frames=12,
                               cam="157.75,157.75,160.0,120.0",
                               noise_sigma=0.0, trace_depth=False, ply=False,
                               min_fts=20, device="cpu"))
    assert "# image source: native prefetcher (PNG: libpng)" in \
        capsys.readouterr().out
    assert rep["frames"] == len(infos) == len(imgs)
    assert infos[0]["stage"] == "first" and infos[1]["stage"] == "second"
    assert {"frames", "wall_s", "fps", "trajectory", "trace"} <= rep.keys()
    assert os.path.exists(tmp_path / "out" / "trace.csv")


def test_jax_driver_file_datasets_fail_where_the_port_runs(tmp_path):
    """rpg_svo_tpu/tools/benchmark.py:316,321 name jnp, which the module
    never imports: the JAX driver cannot read TUM or EuRoC trees."""
    _file_trees(tmp_path, n=3)
    with pytest.raises(NameError, match="jnp"):
        jbench.run(_args(dataset="euroc", path=str(tmp_path / "euroc"),
                         out=str(tmp_path / "jax"), frames=3,
                         noise_sigma=0.0, trace_depth=False, ply=False))


def test_synthetic_dataset_runs_through_the_ports_driver(tmp_path):
    rep = tbench.run(_args(dataset="synthetic", path=None,
                           out=str(tmp_path), frames=20, cam=None,
                           noise_sigma=0.0, trace_depth=False, ply=False,
                           device="cpu"))
    assert rep["frames"] == 19 and rep["ate"]["rmse"] < 0.01
    assert len(np.loadtxt(tmp_path / "traj_estimate.txt")) == 20


def test_driver_cli_defaults_to_the_card():
    """The CLI's --device defaults to cuda, which raises without a card
    (the port never falls back to the CPU on its own)."""
    out = subprocess.run(
        [sys.executable, "-m", "rpg_svo_tpu_torch.tools.benchmark",
         "--dataset", "synthetic", "--frames", "2", "--out", "unused"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"})
    if out.returncode == 0:
        pytest.fail("ran without a card: " + out.stdout[-400:])
    assert "CUDA is not available" in out.stderr
    assert not (ROOT / "unused").exists()
