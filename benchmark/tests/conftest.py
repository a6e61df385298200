"""A copy of the benchmark with two tiny cells of its own, for the CPU
tests: ``tiny_copy`` gives its root.  The cells are data alone (two
configuration files, two traffic files, two limit files and two entries
of the copy's BENCHMARK.json), as a later change would add them, at
widths a CPU runs in seconds."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
# the program and the benchmark's own packages, wherever pytest starts
for _p in (REPO, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TRAIN = "bert_tiny.train.tiny"
GEN = "lm_tiny.gen.tiny"


def _dump(obj, *path) -> None:
    with open(os.path.join(*path), "w") as f:
        json.dump(obj, f, indent=1)


def _load(*path):
    with open(os.path.join(*path)) as f:
        return json.load(f)


def make_tiny(root: str) -> str:
    """Copy ``BENCHMARK.json`` and ``benchmark/`` under ``root`` and add
    the tiny cells; returns ``root``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(root, "benchmark")
    bench = _load(root, "BENCHMARK.json")
    bert = _load(b, "configs", "bert_base.json")
    bert.update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, vocab_size=97,
                max_position_embeddings=16)
    # float32, so the limits and the planted faults stand far from
    # rounding
    bert["precision"] = dict(bert["precision"], compute="float32")
    _dump(bert, b, "configs", "bert_tiny.json")
    lm = _load(b, "configs", "gpt2_small.json")
    # weights wider than the source's 0.02, so that at these widths the
    # context moves the logits well above rounding
    lm.update(n_layer=2, n_embd=32, n_head=2, vocab_size=61, n_positions=64,
              n_ctx=64, initializer_range=0.3)
    lm["serving"] = dict(lm["serving"], slots=4, max_seq=64, num_pages=40,
                         prefill_chunk=16)
    lm["precision"] = dict(lm["precision"], compute="float32")
    _dump(lm, b, "configs", "lm_tiny.json")
    _dump({"kind": "train", "batch": 4, "seq_len": 16, "pool": 5},
          b, "traffic", "train.tiny.json")
    _dump({"kind": "generate", "arrival": {"kind": "closed", "clients": 4},
           "prompt": {"dist": "uniform", "min": 3, "max": 40},
           "output": {"dist": "uniform", "min": 2, "max": 12},
           "max_total": 64, "block": 8, "warmup_s": 0.5,
           "check_tokens": 40}, b, "traffic", "gen.tiny.json")
    _dump({"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2},
          b, "limits", f"{TRAIN}.json")
    _dump({"logit_gap": 1e-4}, b, "limits", f"{GEN}.json")
    for name in ("bert_tiny", "lm_tiny"):
        bench["configs"].append(dict(bench["configs"][0], name=name,
                                     file=f"benchmark/configs/{name}.json",
                                     reduced=[]))
    bench["workloads"] += [
        {"name": TRAIN, "config": "bert_tiny", "traffic": "train.tiny",
         "chips": 1, "why": "CPU test cell"},
        {"name": GEN, "config": "lm_tiny", "traffic": "gen.tiny",
         "chips": 1, "why": "CPU test cell"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TRAIN)
    # the generation metrics, whose readers are in metrics/, as a cell
    # that serves would add them
    bench["end_to_end"][-1:-1] = [
        {"name": name, "unit": unit, "better": better, "bound": 0.25,
         "source": "host_clock", "workloads": [GEN]}
        for name, unit, better in (("gen_tokens_per_s", "tokens/s", "higher"),
                                   ("ttft_p95_ms", "ms", "lower"),
                                   ("tpot_p95_ms", "ms", "lower"))]
    bench["per_layer"] += [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "gen_tokens_per_s", "workloads": [GEN]}
        for name, unit, better, source, layer in (
            ("decode_step_p50_ms.gen", "ms", "lower", "program_span",
             "generation engine"),
            ("mfu_pct.gen", "%", "higher", "host_clock", "model step"),
            ("device_idle_pct.gen", "%", "lower", "device_trace", "device"),
            ("roofline_pct.layernorm.gen", "%", "higher", "device_trace",
             "kernels"))]
    _dump(bench, root, "BENCHMARK.json")
    return root


def run_cell(root: str, workload: str, seed: int = 123456789012,
             seconds: float = 1.0, trace: int = 0, extra=(),
             timeout: float = 300.0) -> subprocess.CompletedProcess:
    """``benchmark/run.py`` of the copy at ``root`` on the CPU, in a
    process of its own (the harness's look for a card skipped), with
    ``extra`` lines of Python run first in that process."""
    code = "\n".join([
        "import sys",
        f"sys.path.insert(0, {os.path.join(root, 'benchmark')!r})",
        *extra,
        "import run",
        f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
        f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
        f"device='cpu'))"])
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


def last_line(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def tiny_copy(tmp_path_factory) -> str:
    return make_tiny(str(tmp_path_factory.mktemp("portbench")))
