"""ctypes wrapper around the native image loader (``loader.cpp``).

Port of ``rpg_svo_tpu/native/loader.py`` over the port's own copy of
``loader.cpp``.  The library is built with ``g++`` on first use into
``build/native/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source: with libpng where it links, else for PGM
alone (``-DSVO_NO_PNG``; ``has_png`` says which).  Without a compiler
``load_gray`` returns None and callers decode with PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
MAX_PIXELS = 4096 * 4096
# (file tag, g++ arguments after the source): libpng first, PGM alone else
_VARIANTS = (("png", ["-lpng", "-lz"]), ("pgm", ["-DSVO_NO_PNG"]))

_lock = threading.Lock()
_lib = None
_tried = False


def _library_path(tag: str) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libsvoloader-{digest}-{tag}.so"


def _compile(out: Path, extra) -> bool:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-Wall", "-pthread",
           "-o", str(tmp), str(SOURCE)] + extra
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    out.with_name(out.stem + ".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        return False
    os.replace(tmp, out)
    return True


def build() -> Optional[Path]:
    """The library, compiled now where no variant is built and loads here;
    None where none compiles (no g++)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for tag, extra in _VARIANTS:
        out = _library_path(tag)
        if not out.exists() and not _compile(out, extra):
            continue
        try:
            ctypes.CDLL(str(out))
        except OSError:     # built elsewhere, against a libpng missing here
            continue
        return out
    return None


def _get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.svo_has_png.argtypes = []
        lib.svo_has_png.restype = ctypes.c_int
        lib.svo_load_gray.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_long]
        lib.svo_load_gray.restype = ctypes.c_int
        lib.svo_prefetch_start.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_long]
        lib.svo_prefetch_start.restype = ctypes.c_int
        lib.svo_prefetch_submit.argtypes = [ctypes.c_long, ctypes.c_char_p]
        lib.svo_prefetch_submit.restype = ctypes.c_int
        lib.svo_prefetch_get.argtypes = [
            ctypes.c_long,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.svo_prefetch_get.restype = ctypes.c_int
        lib.svo_prefetch_stop.argtypes = []
        lib.svo_prefetch_stop.restype = None
        _lib = lib
    return _lib


def has_png() -> bool:
    """Whether the native library decodes PNG (libpng found at build)."""
    lib = _get_lib()
    return lib is not None and bool(lib.svo_has_png())


def load_gray(path: str) -> Optional[np.ndarray]:
    """Decode to grayscale float32 in [0, 255]; None where the library is
    unavailable or does not decode the format (callers then use PIL)."""
    lib = _get_lib()
    if lib is None:
        return None
    buf = np.empty(MAX_PIXELS, dtype=np.float32)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.svo_load_gray(path.encode(), buf, ctypes.byref(w),
                           ctypes.byref(h), MAX_PIXELS)
    if rc != 0:
        return None
    n = w.value * h.value
    return buf[:n].reshape(h.value, w.value).copy()


class NativePrefetcher:
    """The C++ worker-pool prefetch queue (loader.cpp svo_prefetch_*):
    decoding runs on native threads with C++ synchronization, the
    in-flight window (queue_cap) bounded as the reference's frame queue
    (depth_filter.cpp:82-97).  One at a time per process; use as a context
    manager or close it."""

    def __init__(self, n_workers: int = 2, queue_cap: int = 8,
                 max_pixels: int = MAX_PIXELS):
        self._lib = _get_lib()
        if self._lib is None:
            raise RuntimeError("native loader unavailable")
        self.max_pixels = max_pixels
        rc = self._lib.svo_prefetch_start(n_workers, queue_cap, max_pixels)
        if rc != 0:
            raise RuntimeError(f"svo_prefetch_start rc={rc}")

    def submit(self, job_id: int, path: str) -> bool:
        """Enqueue; False if the in-flight window is full (drain first)."""
        rc = self._lib.svo_prefetch_submit(job_id, path.encode())
        if rc == -1:
            return False
        if rc != 0:
            raise RuntimeError(f"svo_prefetch_submit rc={rc}")
        return True

    def get(self, job_id: int) -> np.ndarray:
        """Block until job_id is decoded; returns (H, W) float32."""
        buf = np.empty(self.max_pixels, dtype=np.float32)
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        rc = self._lib.svo_prefetch_get(job_id, buf, ctypes.byref(w),
                                        ctypes.byref(h))
        if rc != 0:
            raise RuntimeError(f"decode failed rc={rc}")
        n = w.value * h.value
        return buf[:n].reshape(h.value, w.value).copy()

    def close(self):
        if self._lib is not None:
            self._lib.svo_prefetch_stop()
            self._lib = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
