"""The one traffic generator: seeds change the order of the work, never
its amount, and the open-loop and shared-prefix mixes that later cells
can add as data files are read as their files say."""

from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import conftest  # noqa: E402
from conftest import GEN, last_line, run_cell  # noqa: E402
from portbench import traffic  # noqa: E402

CHAT = {"prompt": {"dist": "lognormal", "median": 192, "sigma": 0.8,
                   "min": 32, "max": 768},
        "output": {"dist": "lognormal", "median": 192, "sigma": 0.8,
                   "min": 16, "max": 512},
        "max_total": 1024, "block": 64}


def _sizes(mix, seed, n):
    src = traffic.RequestSource(mix, seed, 50257)
    reqs = [src.next() for _ in range(n)]
    return [(p.size, o) for p, o in reqs], reqs


@pytest.mark.parametrize("seed", [1, 2**31 + 5, -7, 10**12])
def test_seeds_reorder_the_same_sizes(seed):
    base, _ = _sizes(CHAT, 0, 128)
    got, reqs = _sizes(CHAT, seed, 128)
    assert sorted(got) == sorted(base)
    # each block of 64 holds the stratified quantiles of both lengths
    assert sorted(p for p, _ in got[:64]) == sorted(
        traffic.quantile_lengths(CHAT["prompt"], 64).tolist())
    assert all(p + o <= 1024 for p, o in got)
    assert all(0 <= int(t.min()) and int(t.max()) < 50257
               for t, _ in reqs)


def test_the_same_seed_gives_the_same_requests():
    _, a = _sizes(CHAT, 99, 70)
    _, b = _sizes(CHAT, 99, 70)
    assert all(np.array_equal(x, y) and u == v
               for (x, u), (y, v) in zip(a, b))


def test_lognormal_median_and_clip():
    x = traffic.quantile_lengths(CHAT["prompt"], 1000)
    assert abs(statistics.median(x) - 192) <= 1
    assert x.min() >= 32 and x.max() <= 768


@pytest.mark.parametrize("arrival, cv", [
    ({"kind": "poisson", "rate": 4.0}, 1.0),
    ({"kind": "gamma", "rate": 4.0, "cv": 2.0}, 2.0)])
def test_open_loop_gaps(arrival, cv):
    gaps = traffic.arrival_gaps(arrival, 3, 4000)
    assert np.mean(gaps) == pytest.approx(0.25, rel=0.02)
    assert np.std(gaps) / np.mean(gaps) == pytest.approx(cv, rel=0.05)
    assert sorted(gaps) == sorted(traffic.arrival_gaps(arrival, 4, 4000))


def test_shared_prefixes_follow_zipf():
    mix = dict(CHAT, shared_prefix={"count": 8, "length": 512, "zipf": 1.0},
               prompt={"dist": "uniform", "min": 32, "max": 128})
    src = traffic.RequestSource(mix, 5, 50257)
    firsts = [tuple(src.next()[0][:512].tolist()) for _ in range(64)]
    counts = sorted((firsts.count(tuple(p.tolist()))
                     for p in src.prefixes), reverse=True)
    assert counts == sorted(traffic.apportion(
        np.arange(1, 9, dtype=float) ** -1.0, 64).tolist(), reverse=True)
    assert counts[0] > counts[-1] > 0


def test_an_open_loop_mix_runs(tmp_path):
    """A Poisson mix added as a data file drives the engine."""
    root = conftest.make_tiny(str(tmp_path))
    path = os.path.join(root, "benchmark", "traffic", "gen.tiny.json")
    with open(path) as f:
        mix = json.load(f)
    mix["arrival"] = {"kind": "poisson", "rate": 40.0}
    with open(path, "w") as f:
        json.dump(mix, f)
    res = last_line(run_cell(root, GEN, seconds=2.0))
    assert res["correct"] is True and res["attempted"] > 20
