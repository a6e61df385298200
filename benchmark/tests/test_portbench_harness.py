"""The harness end to end on the CPU, in copies of the benchmark with the
tiny cells of ``conftest.py``: the result line the contract asks for,
the JAX check on the process that prints it, a cell, a configuration, a
traffic mix and a metric added as data alone, the planted faults that
must turn ``correct`` false, and the refusal without a card."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import conftest  # noqa: E402
from conftest import GEN, TRAIN, last_line, run_cell  # noqa: E402

E2E = {TRAIN: {"train_samples_per_s", "setup_s"},
       GEN: {"gen_tokens_per_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"}}
# the per-layer metrics a CPU run can read (no device trace here)
HOST_LAYER = {TRAIN: {"host_ms_per_step.train", "mfu_pct.train"},
              GEN: {"decode_step_p50_ms.gen", "mfu_pct.gen"}}
FORBIDDEN = ("jax", "jaxlib", "flax", "flexflow_tpu")


@pytest.mark.parametrize("workload", [TRAIN, GEN])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tiny_copy, workload, trace):
    proc = run_cell(tiny_copy, workload, trace=trace)
    res = last_line(proc)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    want = HOST_LAYER[workload] if trace else E2E[workload]
    assert set(res["metrics"]) == want
    for v in res["metrics"].values():
        assert v["value"] > 0 and v["unit"]
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the numbers compared, each beside its limit, last on stderr too
    limits = json.load(open(os.path.join(tiny_copy, "benchmark", "limits",
                                         f"{workload}.json")))
    assert set(res["checks"]) == set(limits)
    tail = proc.stderr.strip().splitlines()[-len(limits):]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)


def test_no_jax_in_the_process_that_prints(tiny_copy):
    """After a whole run, no module whose top-level name is jax, jaxlib,
    flax or flexflow_tpu (flexflow_tpu_torch is another name)."""
    code = "\n".join([
        "import sys, json",
        f"sys.path.insert(0, {os.path.join(tiny_copy, 'benchmark')!r})",
        "import run",
        f"run.main(['--workload', {GEN!r}, '--seed', '5', '--seconds', "
        "'1', '--trace', '0'], device='cpu')",
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_copy,
                          env=dict(os.environ, PYTHONPATH=conftest.REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "flexflow_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_a_loaded_jax_package_refuses_the_result(tiny_copy):
    fake = os.path.join(tiny_copy, "fakejax")
    os.makedirs(os.path.join(fake, "flexflow_tpu"), exist_ok=True)
    open(os.path.join(fake, "flexflow_tpu", "__init__.py"), "w").close()
    proc = run_cell(tiny_copy, TRAIN, extra=[
        f"sys.path.insert(0, {fake!r})", "import flexflow_tpu"])
    assert proc.returncode != 0
    assert "flexflow_tpu" in proc.stderr
    assert '"correct"' not in proc.stdout


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_cell_is_added_by_data_alone(tmp_path):
    """A configuration, a traffic mix, a metric and a workload entry
    added to a copy; every file the benchmark had stays as it was."""
    root = str(tmp_path)
    before = {k: v for k, v in _digests(conftest.BENCH_DIR).items()
              if not k.startswith("tests") and "__pycache__" not in k}
    conftest.make_tiny(root)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "metrics", "checked_tokens.gen.py"), "w") as f:
        f.write("def read(run):\n"
                "    return run.work.get('checked_tokens') or None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "checked_tokens.gen", "unit": "tokens", "better": "higher",
        "source": "host_clock", "layer": "generation engine",
        "moves": "gen_tokens_per_s", "workloads": [GEN]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(b)
    for rel, digest in before.items():
        assert after[rel] == digest, rel
    res = last_line(run_cell(root, GEN, trace=1))
    assert res["correct"] is True
    assert res["metrics"]["checked_tokens.gen"]["value"] > 0


# faults planted under the timed path, in the process of the run
STATE_UNCHANGED = [
    "from flexflow_tpu_torch import optimizers as o",
    "u = o.AdamOptimizer.update",
    "o.AdamOptimizer.update = lambda s, p, g, st: (p, u(s, p, g, st)[1])"]
HALF_BATCH = [
    "from flexflow_tpu_torch.model import FFModel",
    "c = FFModel.compile",
    "def compile(self, *a, **k):",
    "    r = c(self, *a, **k)",
    "    f = self._loss_fn",
    "    self._loss_fn = lambda lg, lb: f(lg[: len(lg) // 2], "
    "lb[: len(lb) // 2])",
    "    return r",
    "FFModel.compile = compile"]
TOKEN_ALTERED = [
    "from flexflow_tpu_torch.serving.generation import engine as e",
    "m = e.GenerationStream._emit",
    "e.GenerationStream._emit = lambda s, t: m(s, (t + 1) % 61)"]
KV_UNWRITTEN = [
    "from flexflow_tpu_torch.ops import attention as a",
    "a._write_rows = lambda *args: None"]


@pytest.mark.parametrize("workload, fault", [
    (TRAIN, STATE_UNCHANGED), (TRAIN, HALF_BATCH),
    (GEN, TOKEN_ALTERED), (GEN, KV_UNWRITTEN)],
    ids=["train-state-unchanged", "train-half-batch", "gen-token-altered",
         "gen-kv-unwritten"])
def test_a_planted_fault_is_not_correct(tiny_copy, workload, fault):
    res = last_line(run_cell(tiny_copy, workload, extra=fault))
    assert res["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in res["checks"].values())


def test_no_card_no_result(tiny_copy):
    """Run as the driver runs it: on a machine without CUDA it exits
    non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", TRAIN, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tiny_copy,
        env=dict(os.environ, PYTHONPATH=conftest.REPO, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(os.path.join(conftest.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(conftest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bert_base.train.s128", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
