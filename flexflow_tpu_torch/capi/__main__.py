"""``python -m flexflow_tpu_torch.capi [--check]``: build the port's C
library and print its path and a host's link line; with ``--check``,
also build ``test_capi.c`` against it and run it, as ``make check`` does
for ``capi/``, in a temporary directory that takes its checkpoint and
strategy file.  The host's ``PYTHONPATH`` holds the repository and this
interpreter's site-packages, so its embedded interpreter imports the
port and its dependencies from a virtual environment too."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

from .build import CAPI, build_host, build_library, host_env, host_link


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv not in ([], ["--check"]):
        print("usage: python -m flexflow_tpu_torch.capi [--check]",
              file=sys.stderr)
        return 2
    print(build_library())
    print("link a host: gcc -I" + CAPI + " host.c "
          + " ".join(host_link()))
    if not argv:
        return 0
    host = build_host(os.path.join(CAPI, "test_capi.c"), "test_capi")
    with tempfile.TemporaryDirectory(prefix="ff-capi-") as cwd:
        return subprocess.run([host], env=host_env(), cwd=cwd).returncode


if __name__ == "__main__":
    sys.exit(main())
