"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/flexflow_tpu_torch/`` at the repository root, and loaded
with ``ctypes``.  The library's file name carries a digest of the source,
of every header in ``csrc/`` and of the flags, so an edited source or
header is rebuilt and a stale build is never loaded.  Nothing links
against libcuda (``-lcuda``): a kernel that needs one of its functions,
such as the TMA tensor-map encoder, looks it up through the CUDA runtime
(``csrc/hopper.cuh``).  Nothing here runs at import: the CPU tests import
every module of the package on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

import torch

# the dtype argument of every kernel's C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "flexflow_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is built: its name carries
    a digest of the source, every ``csrc/*.cuh`` header and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> Tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns ``(path, seconds, compiler output)``.  The output (ptxas's
    registers and spills) is kept beside the library as ``<path>.log``,
    so a library that did not have to be built returns the output of
    its build, and seconds 0.0; one without that file is built again.
    Raises with nvcc's output when the build fails."""
    out = library_path(name)
    log_path = f"{out}.log"
    if os.path.exists(out) and os.path.exists(log_path):
        with open(log_path) as f:
            return out, 0.0, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = (r.stdout + r.stderr).strip()
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {r.returncode}):\n{log}")
    # the log first: a library on disk always has its log beside it
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", log_path)
    os.replace(tmp, out)
    return out, secs, log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _, _ = build(name)
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
        return lib
