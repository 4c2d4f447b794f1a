"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Libraries are
named by a hash of their source, so an edited source is rebuilt and an
unchanged one is reused.  They go to ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``).  No fast math: the alignment kernel's
rollback depends on NaN from the reciprocal square root of a negative pivot
and on NaN-propagating comparisons.  ``function`` declares each entry
point's ``ctypes`` signature once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("tile_gather", "sparse_align", "graph_gate")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns each kernel's ``-Xptxas -v``
    report (registers, shared memory, spills); raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def function(name: str, argtypes: Sequence,
             library: str = "") -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the kernel library ``library`` (by
    default the one of the same name), with its ``argtypes`` and an
    ``int`` (``cudaError_t``) result declared once, at first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load(library or name), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def raw_stream(device) -> int:
    """The handle of PyTorch's current stream on a CUDA device, as an int
    (the stream the kernels launch on), without building a Stream object
    per call."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
