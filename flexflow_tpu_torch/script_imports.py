"""How the runner resolves ``flexflow_tpu`` in the script it runs: the
counterpart of ``python -m flexflow_tpu.cli script.py``, so that the
repo's example scripts (``import flexflow_tpu as ff``, ``from
flexflow_tpu.keras import ...``) run unchanged on the port.

:func:`install` puts a finder first on ``sys.meta_path`` that resolves

- ``flexflow_tpu`` to ``flexflow_tpu_torch``, and ``flexflow_tpu.<sub>``
  to ``flexflow_tpu_torch.<sub>`` by the same dotted path;
- ``flexflow_tpu.torch`` (the JAX package's torch.nn-style frontend) to
  ``flexflow_tpu_torch.nn_compat``, its name in the port.

The finder hands back the port's own module object
(``flexflow_tpu.FFModel is flexflow_tpu_torch.FFModel``) and never loads
a file of the JAX package: a name with no counterpart raises
ModuleNotFoundError naming the port module it looked for.  ``import
jax`` raises ImportError; for a script that has a twin in the port (a
copy that asks the process group, not jax, for its device count, under
``flexflow_tpu_torch/examples/``) the message names the twin.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import os
import sys
from typing import Optional

JAX_PACKAGE = "flexflow_tpu"
PORT = __package__
# names of the JAX package whose port module is named otherwise
RENAMED = {"flexflow_tpu.torch": "flexflow_tpu_torch.nn_compat"}
NO_JAX = ("jax", "jaxlib")
PKG_DIR = os.path.dirname(os.path.abspath(__file__))
# the example scripts that ask jax for the device count, by their path
# under the repo root; each one's twin sits at the same path under
# flexflow_tpu_torch/
TWINS = ("examples/python/native/pipeline_moe_transformer.py",
         "examples/apps/longcontext.py")


def port_name(name: str) -> str:
    """The port module a ``flexflow_tpu`` module name resolves to."""
    for old, new in RENAMED.items():
        if name == old or name.startswith(old + "."):
            return new + name[len(old):]
    return PORT + name[len(JAX_PACKAGE):]


def twin_of(script: str) -> Optional[str]:
    """The path of the port's twin of ``script``, or None."""
    path = os.path.abspath(script).replace(os.sep, "/")
    for rel in TWINS:
        if path.endswith("/" + rel):
            return os.path.join(PKG_DIR, *rel.split("/"))
    return None


def _is_jax_package(name: str) -> bool:
    return name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + ".")


def _is_port(module) -> bool:
    return getattr(module, "__name__", "").split(".")[0] == PORT


def mixing_error() -> Optional[str]:
    """Why a script cannot run on the port in this process, or None: the
    modules of jax or of the JAX package already loaded (the finder's
    own names excluded), since the two packages never run in one
    process."""
    foreign = sorted(name for name, mod in list(sys.modules.items())
                     if name.split(".")[0] in NO_JAX
                     or (_is_jax_package(name) and not _is_port(mod)))
    if not foreign:
        return None
    more = ", ..." if len(foreign) > 4 else ""
    return (f"jax or the JAX package is already imported in this process "
            f"({', '.join(foreign[:4])}{more}); the port runs a script only "
            f"where neither is loaded")


class _Alias(importlib.abc.Loader):
    """Loads a ``flexflow_tpu`` name as the port module ``port``."""

    def __init__(self, port: str):
        self.port = port
        self.spec = None

    def create_module(self, spec):
        module = importlib.import_module(self.port)
        self.spec = module.__spec__
        return module

    def exec_module(self, module) -> None:
        # the import system set the alias's spec on the port's module:
        # give it its own back
        module.__spec__ = self.spec


class ScriptImports(importlib.abc.MetaPathFinder):
    """The finder :func:`install` puts first on ``sys.meta_path``."""

    def __init__(self, script: Optional[str] = None):
        self.script = script
        self.twin = twin_of(script) if script else None

    def no_jax_message(self) -> str:
        msg = ("flexflow_tpu_torch runs no JAX: the runner resolves "
               "flexflow_tpu to the port, and jax cannot be imported "
               "beside it")
        if self.twin:
            msg += (f"; {self.script} asks jax for its devices, run its "
                    f"twin {self.twin} (flexflow-tpu-torch elastic "
                    f"--nprocs N -- {self.twin} ...)")
        return msg

    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in NO_JAX:
            raise ImportError(self.no_jax_message(), name=name)
        if root != JAX_PACKAGE:
            return None
        port = port_name(name)
        try:
            found = importlib.util.find_spec(port)
        except ModuleNotFoundError:
            found = None
        if found is None:
            raise ModuleNotFoundError(
                f"{name} has no counterpart in the port: no module named "
                f"{port!r}", name=port)
        return importlib.util.spec_from_loader(name, _Alias(port))


def install(script: Optional[str] = None) -> None:
    """Put the finder for ``script`` first on ``sys.meta_path`` (the
    runner, just before it runs the script); :func:`uninstall` takes it
    out again."""
    sys.meta_path.insert(0, ScriptImports(script))


def uninstall() -> None:
    """Take every finder of :func:`install` off ``sys.meta_path`` and
    forget the ``flexflow_tpu`` names they resolved, so that the process
    runs on as before (a caller of the runner's ``main`` in process)."""
    sys.meta_path[:] = [f for f in sys.meta_path
                        if not isinstance(f, ScriptImports)]
    for name in [n for n, m in list(sys.modules.items())
                 if _is_jax_package(n) and _is_port(m)]:
        del sys.modules[name]
    # the import system set each renamed module on its parent
    for old, new in RENAMED.items():
        parent, _, child = old.rpartition(".")
        parent = sys.modules.get(port_name(parent))
        if new in sys.modules and \
                getattr(parent, child, None) is sys.modules[new]:
            delattr(parent, child)
