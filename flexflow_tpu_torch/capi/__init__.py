"""The C API over the port: ``capi/``'s flat C surface
(``flexflow_tpu_c.h``, byte for byte the same header, so one ABI) with a
library that embeds ``flexflow_tpu_torch`` where ``capi/``'s embeds the
JAX package.  C programs written for ``capi/`` run unchanged against it.

    python -m flexflow_tpu_torch.capi          # build, print the link line
    python -m flexflow_tpu_torch.capi --check  # build and run test_capi

``build.py`` builds the library and the hosts; ``abi.py`` declares the
library's functions for a running Python (``ctypes.PyDLL``).  An embedded interpreter
runs on the card unless ``FLEXFLOW_PLATFORM=cpu`` asks for the CPU, and
finds a virtual environment's packages only through ``PYTHONPATH``.
"""

from .build import BUILD_DIR, build_host, build_library, host_env, host_link

__all__ = ["BUILD_DIR", "build_host", "build_library", "host_env",
           "host_link"]
