"""The benchmark of flexflow_tpu_torch, the PyTorch and CUDA port.

``run.py`` runs one cell of ``BENCHMARK.json``.  Everything a cell needs
is found by the names in that file: its configuration in
``configs/<config>.json`` (whose ``family`` names the program binding in
``families/`` and the plain reference in ``reference/``), its traffic in
``traffic/<traffic>.json``, its correctness limits in
``limits/<workload>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  This package holds what the cells share: the
traffic generator, the drivers of the two kinds of traffic, the trace
reduction, the peaks and the arithmetic of operations and bytes.
Nothing here imports ``jax`` or the JAX package.
"""
