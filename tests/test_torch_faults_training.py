"""The training and supervisor fire points of ``FF_FAULT`` in the port
(``flexflow_tpu_torch/faults.py``) against the JAX package's
(``flexflow_tpu/faults.py``): for the same plan each gives the JAX
result — ``on_step`` is ``on_window(step - 1, step)``, ``slow_rank``
sleeps once per covered step, kill and hang round up to the window edge
with the same note (both modules run standalone in subprocesses, as the
JAX tests load theirs), ``reshard_at_window``, ``corrupt_ckpt``,
``spawn_fail_requested``, the supervisor's ``backoff_schedule`` and
``_call_sized``.  Then the hooks in the port's train loop and checkpoint
writer, and the loader's and the checkpoint scan's logging.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu import faults as jax_faults
from flexflow_tpu.parallel import elastic as jax_elastic
from flexflow_tpu.parallel.mesh import MachineMesh
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import faults
from flexflow_tpu_torch.fflogger import capture_events
from flexflow_tpu_torch.parallel import elastic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT_FILES = {"jax": os.path.join(REPO, "flexflow_tpu", "faults.py"),
               "port": os.path.join(REPO, "flexflow_tpu_torch", "faults.py")}


@pytest.fixture
def plan(monkeypatch):
    """Install an FF_FAULT plan in both packages at rank 0."""
    def install(value, rank=0):
        monkeypatch.setenv("FF_FAULT", value)
        for mod in (faults, jax_faults):
            mod.reset()
            mod.set_rank(rank)
    yield install
    for mod in (faults, jax_faults):
        mod.reset()


@pytest.fixture
def sleeps(monkeypatch):
    """The sleeps each package's fire points ask for, by package."""
    got = {"port": [], "jax": []}

    class Clock:
        def __init__(self, record):
            self.sleep = record

    # each module's own ``time``: both import the one time module
    monkeypatch.setattr(faults, "time", Clock(got["port"].append))
    monkeypatch.setattr(jax_faults, "time", Clock(got["jax"].append))
    return got


def test_exit_code_and_kinds_match():
    assert faults.KILL_EXIT_CODE == jax_faults.KILL_EXIT_CODE == 17
    assert faults.KINDS == jax_faults.KINDS


def test_on_step_is_on_window_of_one(plan, sleeps):
    plan("slow_rank:0,delay=0.05")
    for mod in (faults, jax_faults):
        mod.on_step(3)
        mod.on_window(2, 3)
    assert sleeps["port"] == sleeps["jax"] == [0.05, 0.05]


@pytest.mark.parametrize("start,end", [(0, 4), (4, 5), (3, 10)])
def test_slow_rank_scales_with_window_width(plan, sleeps, start, end):
    plan("slow_rank:0,delay=0.02")
    faults.on_window(start, end)
    jax_faults.on_window(start, end)
    assert sleeps["port"] == sleeps["jax"]
    assert sleeps["port"] == pytest.approx([0.02 * (end - start)])
    # another rank sleeps in neither package
    plan("slow_rank:0,delay=0.02", rank=1)
    faults.on_window(start, end)
    jax_faults.on_window(start, end)
    assert len(sleeps["port"]) == len(sleeps["jax"]) == 1


_WINDOW_LOADER = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("ff_faults", sys.argv[2])
m = importlib.util.module_from_spec(spec)
sys.modules["ff_faults"] = m
spec.loader.exec_module(m)
m.set_rank(0)
k = int(sys.argv[1])
for end in range(k, 13, k):     # window edges: k, 2k, ... (12 steps)
    m.on_window(end - k, end)
    print("edge", end, flush=True)
print("survived")
"""


def _window_run(pkg, fault, k, timeout=30):
    env = dict(os.environ, FF_FAULT=fault)
    return subprocess.run(
        [sys.executable, "-c", _WINDOW_LOADER, str(k), FAULT_FILES[pkg]],
        env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("fault,k", [("kill_at_step:5", 4),
                                     ("kill_at_step:8", 4),
                                     ("kill_at_step:8", 1),
                                     ("kill_at_step:3,rank=1", 1),
                                     ("kill_at_step:7,exit=9", 3)])
def test_kill_rounds_up_to_the_window_edge_as_jax(fault, k):
    """Each package's module alone in a subprocess: the same exit code,
    the same edges passed and the same injection note."""
    port, ref = _window_run("port", fault, k), _window_run("jax", fault, k)
    assert port.returncode == ref.returncode
    assert port.stdout == ref.stdout
    assert port.stderr == ref.stderr
    if "rank=1" not in fault:
        assert "injected kill" in port.stderr


def test_hang_rounds_up_to_the_window_edge_as_jax():
    """hang_at_step:3 under 4-step windows stops progress inside the
    step-4 edge hook in both packages (a timeout ends it here)."""
    out = {}
    for pkg in ("port", "jax"):
        with pytest.raises(subprocess.TimeoutExpired) as ei:
            _window_run(pkg, "hang_at_step:3", 4, timeout=3)
        out[pkg] = ((ei.value.stdout or b"").decode(errors="replace"),
                    (ei.value.stderr or b"").decode(errors="replace"))
    assert out["port"] == out["jax"]
    assert "edge 4" not in out["port"][0]
    assert "injected hang at step 4" in out["port"][1]
    assert "requested step 3 rounded up" in out["port"][1]


@pytest.mark.parametrize("value,rank,attempt", [
    ("shrink_at_step:5,devices=2", 0, "0"),
    ("grow_at_step:2", 0, "0"),
    ("grow_at_step:3;shrink_at_step:6,devices=2", 0, "0"),
    ("shrink_at_step:5,devices=2,rank=1", 0, "0"),
    ("shrink_at_step:5,devices=2,rank=1", 1, "0"),
    ("shrink_at_step:5", 0, "1"),
    ("shrink_at_step:5,attempt=*", 0, "1"),
])
def test_reshard_at_window_matches_jax(plan, monkeypatch, value, rank,
                                       attempt):
    monkeypatch.setenv("FF_ELASTIC_ATTEMPT", attempt)
    plan(value, rank=rank)
    for start, end in ((0, 4), (1, 2), (4, 8), (8, 12), (0, 8)):
        assert faults.reshard_at_window(start, end) == \
            jax_faults.reshard_at_window(start, end), (start, end)


@pytest.mark.parametrize("value", ["corrupt_ckpt:4", "corrupt_ckpt:latest",
                                   "corrupt_ckpt:4,rank=1",
                                   "corrupt_ckpt:2,attempt=1"])
def test_corrupt_ckpt_matches_jax(plan, tmp_path, value):
    """The same files truncated to the same sizes, for each step."""
    plan(value)
    sizes = {}
    for pkg, mod in (("port", faults), ("jax", jax_faults)):
        for step in (2, 4):
            p = os.path.join(tmp_path, f"{pkg}_{step}.bin")
            with open(p, "wb") as f:
                f.write(bytes(range(256)) * 8)
            mod.maybe_corrupt_checkpoint(p, step)
            sizes[(pkg, step)] = os.path.getsize(p)
    assert [sizes[("port", s)] for s in (2, 4)] == \
        [sizes[("jax", s)] for s in (2, 4)]


@pytest.mark.parametrize("value", ["", "spawn_fail_attempt:0",
                                   "spawn_fail_attempt:1",
                                   "kill_at_step:3;spawn_fail_attempt:2"])
def test_spawn_fail_requested_matches_jax(value):
    env = {"FF_FAULT": value} if value else {}
    for attempt in range(4):
        assert faults.spawn_fail_requested(env, attempt) == \
            jax_faults.spawn_fail_requested(env, attempt)


@pytest.mark.parametrize("kw", [{}, dict(base_s=0.01, max_s=0.05, seed=3),
                                dict(jitter=0.0), dict(seed=11)])
def test_backoff_schedule_is_the_jax_schedule(kw):
    assert elastic.backoff_schedule(6, **kw) == \
        jax_elastic.backoff_schedule(6, **kw)


def test_call_sized_matches_jax():
    fns = [lambda a, p, r: (a, p, r), lambda a, p, r, n: n,
           lambda a, p, r, extra="x": extra, lambda *a: a]
    for fn in fns:
        assert elastic._call_sized(fn, 1, 2, 3, 8) == \
            jax_elastic._call_sized(fn, 1, 2, 3, 8)


def test_classify_matches_jax():
    cases = [(None, False, False, None, {}), ("OSError", False, False, 0, {}),
             (None, True, False, 1, {}), (None, False, True, 1, {}),
             (None, False, False, 1, {0: "Address already in use"}),
             (None, False, False, 1, {1: "boom"})]
    for c in cases:
        assert elastic._classify(*c) == jax_elastic._classify(*c)


# ----------------------------------------------------------------------
# the hooks in the port's train loop and checkpoint writer
# ----------------------------------------------------------------------
def _mlp(k=1, pkg=ft):
    cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32")
    cfg.steps_per_dispatch = k
    kw = {"device": "cpu"} if pkg is ft else {"mesh": MachineMesh({"n": 1})}
    m = pkg.FFModel(cfg, **kw)
    x = m.create_tensor((8, 4), name="x")
    m.dense(x, 3)
    m.compile(pkg.SGDOptimizer(lr=0.1))
    m.init_layers(seed=0)
    return m


def _data(n=8 * 6):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            rng.integers(0, 3, (n, 1)).astype(np.int32))


@pytest.mark.parametrize("k", [1, 3])
def test_fit_and_train_batch_fire_the_window_hooks(plan, sleeps, k):
    """slow_rank through the port's fit (one sleep a window of k steps)
    and train_batch/train_window, as the JAX model's verbs ask."""
    plan("slow_rank:0,delay=0.01")
    xs, ys = _data()
    for pkg in (ft, ff):
        m = _mlp(k, pkg)
        m.fit(xs, ys, epochs=1, verbose=False)
        m.train_batch(xs[:8], ys[:8])
        m.train_window((xs[:16].reshape(2, 8, 4), ys[:16].reshape(2, 8, 1)))
    assert sleeps["port"] == sleeps["jax"]
    assert sum(sleeps["port"]) == pytest.approx(0.01 * (6 + 1 + 2))


def test_no_plan_costs_one_cached_check(monkeypatch):
    """Without FF_FAULT a step never reaches a fire point."""
    monkeypatch.delenv("FF_FAULT", raising=False)
    faults.reset()

    def boom(*a):
        raise AssertionError("fire point reached without a plan")

    monkeypatch.setattr(faults, "on_window", boom)
    monkeypatch.setattr(faults, "reshard_at_window", boom)
    m = _mlp(2)
    xs, ys = _data()
    m.fit(xs, ys, epochs=1, verbose=False)
    m.train_batch(xs[:8], ys[:8])
    assert m._step == 7


def test_save_checkpoint_corrupts_as_jax(plan, tmp_path):
    """corrupt_ckpt:2 truncates the step-2 file each package publishes
    and no other; both fail verification."""
    from flexflow_tpu.resilience import verify_checkpoint as jax_verify
    from flexflow_tpu_torch.resilience import verify_checkpoint
    plan("corrupt_ckpt:2")
    xs, ys = _data()
    for pkg, verify in ((ft, verify_checkpoint), (ff, jax_verify)):
        m = _mlp(1, pkg)
        for step in (1, 2, 3):
            m.train_batch(xs[:8], ys[:8])
            m.save_checkpoint(os.path.join(
                tmp_path, f"{pkg.__name__}_step{step}.npz"))
        assert [verify(os.path.join(tmp_path, f"{pkg.__name__}_step{s}.npz"))
                for s in (1, 2, 3)] == [True, False, True]


def test_fit_kill_fires_at_the_window_edge(tmp_path):
    """A real fit under steps_per_dispatch=4 with kill_at_step:2 dies at
    the step-4 edge with the kill's exit code."""
    worker = (
        "import numpy as np, flexflow_tpu_torch as ft\n"
        "cfg = ft.FFConfig(batch_size=8, compute_dtype='float32')\n"
        "cfg.steps_per_dispatch = 4\n"
        "m = ft.FFModel(cfg, device='cpu')\n"
        "x = m.create_tensor((8, 4), name='x')\n"
        "m.dense(x, 3)\n"
        "m.compile(ft.SGDOptimizer(lr=0.1))\n"
        "m.init_layers(seed=0)\n"
        "rng = np.random.default_rng(0)\n"
        "xv = rng.standard_normal((64, 4)).astype(np.float32)\n"
        "yv = rng.integers(0, 3, (64, 1)).astype(np.int32)\n"
        "m.fit(xv, yv, epochs=1, verbose=False)\n"
        "print('survived')\n")
    env = dict(os.environ, FF_FAULT="kill_at_step:2", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", worker], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == faults.KILL_EXIT_CODE, r.stderr[-2000:]
    assert "survived" not in r.stdout
    assert "injected kill at step 4" in r.stderr
    assert "requested step 2 rounded up" in r.stderr


def test_shrink_outside_the_supervisor_names_run_elastic(plan):
    """A shrink to another world size from a one-process run, with no
    supervisor around it, raises naming run_elastic."""
    plan("shrink_at_step:1,devices=2")
    m = _mlp()
    xs, ys = _data()
    with pytest.raises(ValueError, match="run_elastic"):
        m.train_batch(xs[:8], ys[:8])


# ----------------------------------------------------------------------
# logging repairs: the loader and the checkpoint scan log as JAX does
# ----------------------------------------------------------------------
def test_ragged_fit_warns_nothing_and_logs_the_tail(capsys):
    """A ragged fit logs the dropped tail on the ff logger (info) and
    raises no UserWarning under -W error::UserWarning."""
    code = (
        "import warnings, numpy as np, flexflow_tpu_torch as ft\n"
        "warnings.simplefilter('error', UserWarning)\n"
        "cfg = ft.FFConfig(batch_size=8, compute_dtype='float32')\n"
        "m = ft.FFModel(cfg, device='cpu')\n"
        "x = m.create_tensor((8, 4), name='x')\n"
        "m.dense(x, 3)\n"
        "m.compile(ft.SGDOptimizer(lr=0.1))\n"
        "m.init_layers(seed=0)\n"
        "rng = np.random.default_rng(0)\n"
        "m.fit(rng.standard_normal((21, 4)).astype(np.float32),\n"
        "      rng.integers(0, 3, (21, 1)).astype(np.int32), epochs=1,\n"
        "      verbose=False)\n"
        "m.fit(np.zeros((3, 4), np.float32), np.zeros((3, 1), np.int32),\n"
        "      epochs=1, verbose=False)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-W", "error::UserWarning", "-c",
                        code], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[ff] info: dropping 5 tail samples" in r.stderr
    assert "[ff] warning: dataset (3 samples) is smaller than" in r.stderr


def test_latest_valid_checkpoint_emits_skip_event(tmp_path, capsys):
    """tests/test_faults.py's pin held in both packages: the same file
    skipped, with the same event fields."""
    import json

    from flexflow_tpu.parallel.elastic import \
        latest_valid_checkpoint as jax_latest
    from flexflow_tpu_torch.parallel.elastic import latest_valid_checkpoint
    from flexflow_tpu_torch.resilience import (MANIFEST_KEY, _atomic_savez,
                                               build_manifest)
    paths = {}
    for step in (2, 4):
        rng = np.random.default_rng(step)
        flat = {"param:w": rng.standard_normal((4, 3)).astype(np.float32),
                "meta:step": np.asarray(step, np.int64)}
        flat[MANIFEST_KEY] = np.asarray(build_manifest(flat, step))
        paths[step] = _atomic_savez(
            os.path.join(tmp_path, f"elastic_step{step}.npz"), flat)
    faults.corrupt_file(paths[4])
    with capture_events("elastic") as port_events:
        assert latest_valid_checkpoint(str(tmp_path)) == paths[2]
    capsys.readouterr()
    assert jax_latest(str(tmp_path)) == paths[2]
    jax_events = [json.loads(line) for line in
                  capsys.readouterr().out.splitlines()
                  if line.startswith("{")]
    drop = ("t", "t_ns", "reason")
    mine = [{k: v for k, v in e.items() if k not in drop}
            for e in port_events]
    theirs = [{k: v for k, v in e.items() if k not in drop}
              for e in jax_events if e["event"] == "checkpoint_skipped"]
    assert mine == theirs == [{"cat": "elastic",
                               "event": "checkpoint_skipped",
                               "path": paths[4], "step": 4}]
    assert "CorruptCheckpointError" in port_events[0]["reason"]
