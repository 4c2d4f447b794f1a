"""Experiment configuration: the reference's YAML composition layer.

Port of ``rpg_svo_tpu/io/experiment.py`` (svo_analysis/scripts/
benchmark.py:18-43), which merges three YAML layers before a run:

1. the experiment file (experiment_label, param_settings, dataset or
   datasets; svo_analysis/experiments/*.yaml);
2. the algorithm parameters it names (svo_ros/param/vo_fast.yaml,
   vo_accurate.yaml: flat ``<param>: <value>`` overriding Config);
3. each dataset's own dataset_params.yaml (camera intrinsics under cam0,
   dataset_is_blender, dataset_first_frame, dataset_noise_sigma).

The reference's parameter names are the port's Config field names.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import yaml

from rpg_svo_tpu_torch.config import Config, accurate_preset, fast_preset
from rpg_svo_tpu_torch.geometry.cameras import ATANCamera, PinholeCamera


@dataclasses.dataclass
class Experiment:
    label: str
    param_settings: str
    datasets: List[str]
    extra: Dict[str, Any]


def load_experiment(path: str) -> Experiment:
    """Parse an experiment YAML (svo_analysis/experiments format)."""
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    datasets = d.get("datasets")
    if datasets is None:
        datasets = [d["dataset"]] if "dataset" in d else []
    known = {"experiment_label", "param_settings", "dataset", "datasets"}
    return Experiment(
        label=str(d.get("experiment_label", os.path.basename(path))),
        param_settings=str(d.get("param_settings", "vo_fast")),
        datasets=[str(x) for x in datasets],
        extra={k: v for k, v in d.items() if k not in known})


def load_algo_config(param_settings: str,
                     search_dirs: Optional[List[str]] = None) -> Config:
    """A Config for a param_settings name: "vo_fast" and "vo_accurate" are
    the presets (svo_ros/param/*.yaml); any other name, or a path, is a
    flat YAML of Config overrides on top of the fast preset."""
    if param_settings == "vo_fast":
        return fast_preset()
    if param_settings == "vo_accurate":
        return accurate_preset()
    path = param_settings
    if not os.path.exists(path) and search_dirs:
        for d in search_dirs:
            cand = os.path.join(d, param_settings + ".yaml")
            if os.path.exists(cand):
                path = cand
                break
    with open(path) as f:
        overrides = yaml.safe_load(f) or {}
    return apply_param_overrides(fast_preset(), overrides)


def apply_param_overrides(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """Apply reference-named parameters to a Config, ignoring unknown keys
    (the reference's YAMLs carry ROS-only keys such as cam_topic)."""
    fields = {f.name for f in dataclasses.fields(Config)}
    known = {k: v for k, v in overrides.items()
             if k in fields and v is not None}
    return cfg.replace(**known) if known else cfg


def load_dataset_params(dataset_dir: str) -> Dict[str, Any]:
    """<dataset_dir>/dataset_params.yaml, or {} where there is none."""
    path = os.path.join(dataset_dir, "dataset_params.yaml")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return yaml.safe_load(f) or {}


def camera_from_params(p: Dict[str, Any]):
    """A camera from dataset_params (its cam0 block or flat cam_* keys),
    dispatched on cam_model as vikit's camera_loader does."""
    cam = p.get("cam0", p)
    model = str(cam.get("cam_model", "Pinhole")).lower()
    w = int(cam.get("cam_width", 752))
    h = int(cam.get("cam_height", 480))
    if model == "atan":
        # normalized PTAM intrinsics, which ATANCamera.make scales once
        # (the JAX package scales them here as well, twice in all)
        return ATANCamera.make(w, h, float(cam["cam_fx"]),
                               float(cam["cam_fy"]), float(cam["cam_cx"]),
                               float(cam["cam_cy"]), float(cam["cam_d0"]))
    return PinholeCamera.make(
        w, h, float(cam["cam_fx"]), float(cam["cam_fy"]),
        float(cam["cam_cx"]), float(cam["cam_cy"]),
        float(cam.get("cam_d0", 0.0)), float(cam.get("cam_d1", 0.0)),
        float(cam.get("cam_d2", 0.0)), float(cam.get("cam_d3", 0.0)))
