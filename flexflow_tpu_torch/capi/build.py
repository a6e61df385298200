"""Build the C API over the port: the counterpart of ``capi/Makefile``.

``build_library()`` compiles ``capi/flexflow_tpu_c.cpp``, unchanged, with
``g++`` into ``build/flexflow_tpu_torch/capi/`` at the repository root,
linked with ``-Wl,--wrap=PyImport_ImportModule`` beside
``import_port.cpp``, which turns its imports of ``flexflow_tpu[.<sub>]``
into ``flexflow_tpu_torch[.<sub>]``.  The library holds no device code
(no ``nvcc``) and is linked without libpython: its
Python symbols come from the process that loads it, either a C host
linked with libpython or a running Python that loads it with
``ctypes.PyDLL``, which then never starts a second interpreter.

``build_host(c_source, name, shared=False)`` compiles a C program,
unchanged, against the library: an executable linked with the library
and then libpython, or (``shared=True``) a shared object whose ``main`` a
running Python calls through ``ctypes.PyDLL``, with no libpython.

Python's include directory and library come from the running
interpreter's ``sysconfig``, not from ``python3-config``, which may
belong to another Python.  Every output's name carries a digest of its
sources, the header and the flags, and is written under a temporary name
and renamed, so processes that build at once share one build and a
stale build is never loaded.  Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import site
import subprocess
import sysconfig
import threading
from typing import Dict, List, Optional, Sequence

CAPI = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(CAPI))
SOURCES = (os.path.join(REPO, "capi", "flexflow_tpu_c.cpp"),
           os.path.join(CAPI, "import_port.cpp"))
HEADER = os.path.join(CAPI, "flexflow_tpu_c.h")
BUILD_DIR = os.path.join(REPO, "build", "flexflow_tpu_torch", "capi")
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall")
# capi/flexflow_tpu_c.cpp's imports go through import_port.cpp
LDFLAGS = ("-Wl,--wrap=PyImport_ImportModule",)
CFLAGS = ("-O2", "-Wall")
TIMEOUT = 300


def python_include() -> str:
    """The running interpreter's include directory; raises where it has
    no ``Python.h`` (no development headers: nothing can embed it)."""
    inc = sysconfig.get_config_var("INCLUDEPY") or ""
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"no Python.h in {inc!r} (sysconfig INCLUDEPY): "
                           f"this Python has no development headers")
    return inc


def python_link() -> List[str]:
    """The flags that link a C host with the running interpreter's
    shared libpython; raises where it has none."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    shared = sysconfig.get_config_var("Py_ENABLE_SHARED")
    if not (shared and os.path.exists(os.path.join(libdir, ldlib))):
        raise RuntimeError(f"no shared libpython ({ldlib!r} in {libdir!r}, "
                           f"Py_ENABLE_SHARED={shared}): a C host cannot "
                           f"embed this Python")
    name = ldlib[len("lib"):].split(".so")[0]
    return [f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{libdir}", "-ldl",
            "-lm"]


def _digest(paths: Sequence[str], *extra: str) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read() + b"\0")
    for e in extra:
        h.update(e.encode() + b"\0")
    return h.hexdigest()[:12]


def _compile(out: str, cmd: List[str]) -> str:
    """Run ``cmd -o <temporary name>`` unless ``out`` exists, then
    rename the output to ``out``; returns ``out``."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        r = subprocess.run(cmd + ["-o", tmp], capture_output=True,
                           text=True, timeout=TIMEOUT)
        if r.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                               f"{r.returncode}):\n{r.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library_path() -> str:
    """Where :func:`build_library` puts the library."""
    inc = python_include()
    d = _digest([*SOURCES, HEADER], *CXXFLAGS, *LDFLAGS, inc)
    return os.path.join(BUILD_DIR, f"libflexflow_tpu_c-{d}.so")


def build_library() -> str:
    """Compile the library unless an up-to-date one exists; returns its
    path.  Linked without libpython."""
    out = library_path()
    soname = os.path.basename(out)
    return _compile(out, ["g++", *CXXFLAGS, "-shared", f"-I{CAPI}",
                          f"-I{python_include()}", *SOURCES, *LDFLAGS,
                          f"-Wl,-soname,{soname}"])


def host_link(shared: bool = False) -> List[str]:
    """The flags after a host's source: the library (found at run time
    in its build directory), then libpython for an executable."""
    lib = build_library()
    flags = [lib, f"-Wl,-rpath,{BUILD_DIR}"]
    return flags if shared else flags + python_link()


def build_host(c_source: str, name: str, shared: bool = False) -> str:
    """Compile the C program ``c_source``, unchanged, against the
    library; returns the path of the executable (or, with ``shared``,
    of a shared object to load with ``ctypes.PyDLL`` and call ``main``
    in).  The header is found beside the library's source."""
    link = host_link(shared)
    kind = ("-fPIC", "-shared") if shared else ()
    d = _digest([c_source, HEADER], *CFLAGS, *kind, *link)
    out = os.path.join(BUILD_DIR, f"{name}-{d}{'.so' if shared else ''}")
    return _compile(out, ["gcc", *CFLAGS, *kind, f"-I{CAPI}", c_source,
                          *link])


def host_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """A copy of ``env`` (default: this process's environment) whose
    ``PYTHONPATH`` starts with the repository and this interpreter's
    site-packages: a host's embedded interpreter imports the port, and
    the packages of a virtual environment, only through it."""
    env = dict(os.environ if env is None else env)
    paths = [REPO, *site.getsitepackages(), env.get("PYTHONPATH")]
    env["PYTHONPATH"] = os.pathsep.join(p for p in paths if p)
    return env
