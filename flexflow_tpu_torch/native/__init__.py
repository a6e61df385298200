"""The native event-driven simulator (``simulator.cpp``), the search's
hot loop, loaded through ctypes.

The library is built at first use with ``g++`` into
``build/flexflow_tpu_torch/`` at the repository root, under a name that
carries a digest of the source, and installed with an atomic rename, so
processes that build it at once never load a half-written file and an
edited source is rebuilt.  Without a compiler ``load_ffsim()`` warns and
returns None, and the simulator runs its pure-Python engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "simulator.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "flexflow_tpu_torch")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the library is built: its name carries a digest of the
    source and the flags."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libffsim-{h.hexdigest()[:12]}.so")


def _build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            warnings.warn(f"native simulator build failed: {r.stderr[:500]}")
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        warnings.warn(f"native simulator build unavailable: {e}; the "
                      f"simulator runs its pure-Python engine")
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def load_ffsim() -> Optional[ctypes.CDLL]:
    """The compiled simulator library, built on first use; None (after
    one warning) where it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            warnings.warn(f"native simulator load failed: {e}")
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        f64 = ctypes.c_double
        lib.ffsim_version.restype = ctypes.c_int32
        if lib.ffsim_version() < 2:
            warnings.warn("native simulator library is stale; the "
                          "simulator runs its pure-Python engine")
            return None
        lib.ffsim_simulate.restype = f64
        lib.ffsim_simulate.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            f64p, f64p, f64p,          # fwd, bwd, sync times
            i32p, i64p, i64p,          # rank, out_shape, out_dims
            i32p, i32p,                # dev_off, dev_ids
            i32p, i32p, i32p, i64p,    # in_off, in_producer, in_rank, in_shape
            ctypes.c_int32,
            f64, f64, f64, f64,
        ]
        # the stateful delta-simulation API (SimSession): the static
        # topology marshalled once, then one op's row per proposal
        lib.ffsim_create.restype = ctypes.c_void_p
        lib.ffsim_create.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, i64p,                # rank, out_shape
            i32p, i32p, i32p, i64p,    # in_off, in_producer, in_rank, in_shape
            f64, f64, f64, f64,        # ici_bw, dcn_bw, latency, dtype_bytes
            f64,                       # delta-repair threshold
        ]
        lib.ffsim_update_op.restype = ctypes.c_int32
        lib.ffsim_update_op.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            f64, f64, f64,             # fwd, bwd, sync
            i64p,                      # dims (MAXD, 1-padded)
            ctypes.c_int32, i32p,      # n_dev, dev_ids
        ]
        lib.ffsim_state_simulate.restype = f64
        lib.ffsim_state_simulate.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ffsim_destroy.restype = None
        lib.ffsim_destroy.argtypes = [ctypes.c_void_p]
        lib.ffsim_stat.restype = ctypes.c_int64
        lib.ffsim_stat.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        _lib = lib
        return _lib
