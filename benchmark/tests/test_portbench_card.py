"""On the card, at each cell's own sizes: the control (the plain
reference with its products' operands in fp8, one precision below the
configuration's bf16, in the program's place) and, for training, half of
each batch left out, come out not correct against the cell's limits,
while the program's own readings on the same seed stay within them.
Marked ``cuda``; the fixture skips where there is no card.

    python -m pytest benchmark/tests/test_portbench_card.py -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not numbers[k] <= lim for k, lim in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_at_the_cells_size(card, workload):
    with open(os.path.join(BENCH_DIR, "limits", f"{workload}.json")) as f:
        limits = json.load(f)
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "readings.py"),
         "--workload", workload, "--seeds", "977", "--seconds", "10"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    reading = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not _fails(reading["program"], limits), reading
    assert _fails(reading["control"], limits), reading
    if "half_batch" in reading:
        assert _fails(reading["half_batch"], limits), reading
