"""Dataset readers: the Blender/sin2 layout, TUM RGB-D, EuRoC MAV.

Port of ``rpg_svo_tpu/io/datasets.py`` (BenchmarkNode's images.txt /
trajectory.txt parsing and vikit's blender_utils depth maps,
svo_ros/src/benchmark_node.cpp:133-256; the TUM and EuRoC layouts).
Images are decoded on the host by the native loader
(``rpg_svo_tpu_torch/native/loader.cpp``: PGM, and PNG where libpng was
found at build time), else by PIL, and stay numpy arrays until the
FrameHandler copies them to its device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from rpg_svo_tpu_torch.geometry.se3 import SE3
from rpg_svo_tpu_torch.io.trajectory import read_tum, tum_to_se3
from rpg_svo_tpu_torch.native import loader as native_loader


def load_image_gray(path: str) -> np.ndarray:
    """Grayscale float32 image in [0, 255]: the native loader, else PIL."""
    img = native_loader.load_gray(path)
    if img is not None:
        return img
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.float32)


class BlenderDataset:
    """The reference test-dataset layout (sin2_tex2_h1_v8_d):
    <dir>/trajectory.txt lines ``img_name tx ty tz qx qy qz qw`` (vikit
    FileType::ImageNameAndPose), images <dir>/img/<name>_0.png, float depth
    maps <dir>/depth/<name>_0.depth (one value per pixel, depth along the
    bearing ray)."""

    def __init__(self, root: str):
        self.root = root
        self.entries: List[Tuple[str, np.ndarray, np.ndarray]] = []
        with open(os.path.join(root, "trajectory.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = line.split()
                vals = [float(x) for x in v[1:9]]
                self.entries.append((v[0], np.asarray(vals[:3]),
                                     np.asarray(vals[3:7])))

    def __len__(self):
        return len(self.entries)

    def frame(self, i: int):
        """Returns (img float32 (H, W), T_w_c: SE3 on the CPU, name)."""
        name, t, q = self.entries[i]
        img = load_image_gray(os.path.join(self.root, "img",
                                           name + "_0.png"))
        T = tum_to_se3(t[None], q[None])
        return img, SE3(T.R[0], T.t[0]), name

    def depth(self, i: int, shape: Tuple[int, int]) -> Optional[np.ndarray]:
        """The depth map of frame i, or None where the frame has none."""
        p = os.path.join(self.root, "depth", self.entries[i][0] + "_0.depth")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            vals = np.array(f.read().split(), dtype=np.float32)
        return vals.reshape(shape)


class TUMDataset:
    """TUM RGB-D monocular: <dir>/rgb.txt (timestamp path) and
    <dir>/groundtruth.txt (timestamp tx ty tz qx qy qz qw)."""

    def __init__(self, root: str):
        self.root = root
        self.frames: List[Tuple[float, str]] = []
        with open(os.path.join(root, "rgb.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                self.frames.append((float(ts), rel))
        gt_path = os.path.join(root, "groundtruth.txt")
        self.gt = read_tum(gt_path) if os.path.exists(gt_path) else None

    def __len__(self):
        return len(self.frames)

    def frame(self, i: int):
        ts, rel = self.frames[i]
        return load_image_gray(os.path.join(self.root, rel)), ts

    def image_path(self, i: int) -> str:
        return os.path.join(self.root, self.frames[i][1])

    def timestamp(self, i: int) -> float:
        return self.frames[i][0]


class EuRoCDataset:
    """EuRoC MAV: <dir>/mav0/cam0/data.csv (images under data/) and
    <dir>/mav0/state_groundtruth_estimate0/data.csv."""

    def __init__(self, root: str, cam: str = "cam0"):
        self.root = root
        base = os.path.join(root, "mav0", cam)
        self.img_dir = os.path.join(base, "data")
        self.frames: List[Tuple[float, str]] = []
        with open(os.path.join(base, "data.csv")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts_ns, name = line.split(",")[:2]
                self.frames.append((int(ts_ns) * 1e-9, name.strip()))
        self.gt = None
        gt_csv = os.path.join(root, "mav0", "state_groundtruth_estimate0",
                              "data.csv")
        if os.path.exists(gt_csv):
            rows = np.loadtxt(gt_csv, delimiter=",", skiprows=1)
            # EuRoC's quaternion order is qw qx qy qz: to xyzw
            self.gt = (rows[:, 0] * 1e-9, rows[:, 1:4], rows[:, [5, 6, 7, 4]])

    def __len__(self):
        return len(self.frames)

    def frame(self, i: int):
        ts, name = self.frames[i]
        return load_image_gray(os.path.join(self.img_dir, name)), ts

    def image_path(self, i: int) -> str:
        return os.path.join(self.img_dir, self.frames[i][1])

    def timestamp(self, i: int) -> float:
        return self.frames[i][0]


class PrefetchingSource:
    """Background-thread prefetcher over any dataset with .frame(i): the
    reference's frame queue between the camera callback and the pipeline
    (depth_filter.cpp:82-97).  Yields (i, dataset.frame(i)) in order."""

    def __init__(self, dataset, n_ahead: int = 4):
        import queue
        import threading
        self.ds = dataset
        self.q = queue.Queue(maxsize=n_ahead)
        self._stop = threading.Event()

        def worker():
            for i in range(len(dataset)):
                if self._stop.is_set():
                    break
                self.q.put((i, dataset.frame(i)))
            self.q.put(None)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item

    def close(self):
        self._stop.set()


class NativePrefetchingSource:
    """File-dataset prefetcher on the native worker pool (loader.cpp
    svo_prefetch_*): decoding runs on native threads, the in-flight window
    is bounded in C++, frames come back in order.  For datasets whose
    frames are image files (.image_path(i), .timestamp(i)); raises
    RuntimeError where the native library is unavailable."""

    def __init__(self, dataset, n_workers: int = 2, n_ahead: int = 6):
        self.ds = dataset
        self.pf = native_loader.NativePrefetcher(n_workers=n_workers,
                                                 queue_cap=n_ahead)
        self._submitted = 0

    def _pump(self):
        while self._submitted < len(self.ds):
            if not self.pf.submit(self._submitted,
                                  self.ds.image_path(self._submitted)):
                break
            self._submitted += 1

    def __iter__(self):
        try:
            self._pump()
            for i in range(len(self.ds)):
                img = self.pf.get(i)
                self._pump()
                yield i, (img, self.ds.timestamp(i))
        finally:
            self.close()

    def close(self):
        if self.pf is not None:
            self.pf.close()
            self.pf = None
