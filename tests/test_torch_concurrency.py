"""The port's lock-discipline analysis (``flexflow_tpu_torch/analysis/
concurrency.py``) against the JAX package's, on the CPU.

* The known-bad corpus of ``tests/test_concurrency_analysis.py`` (one
  class per FF150-FF154, the waivers, the ABBA cycle) gives the same
  codes at the same ``corpus/<mod>.py:<line>`` sites, and the same
  static edges, under both packages' analyses.
* The port's own blocking leaves fire FF152: ``torch.cuda.synchronize``
  (and a stream's or event's ``synchronize``) and ``.cpu()`` under a
  lock, the port's counterparts of the JAX package's ``device_get`` and
  ``block_until_ready``.
* The port's tree lints at zero ERROR findings with an acyclic static
  graph, and the roster keeps the serving stack's load-bearing locks.
* A process with ``FF_LOCKWATCH=1`` (``tests/_torch_lockwatch_worker.py``:
  the dense, generation and fleet engines and a metrics scrape) observes
  only edges the static graph holds, and no cycle.
"""

import json
import os
import subprocess
import sys

import pytest

from flexflow_tpu.analysis import concurrency as jax_cz
from flexflow_tpu_torch import cli
from flexflow_tpu_torch.analysis import concurrency as cz
from flexflow_tpu_torch.obs import lockwatch

from test_concurrency_analysis import _CORPUS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WAIVED = {
    "waived_sleep.py": (
        "import threading\n"
        "import time\n\n\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n\n"
        "    def ok(self):\n"
        "        with self._lock:\n"
        "            time.sleep(0.1)  # lock-ok: test waiver\n"),
    "waived_field.py": (
        "import threading\n\n\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._n = 0  # guarded_by: self._lock\n\n"
        "    def a(self):\n"
        "        with self._lock:\n"
        "            self._n += 1\n\n"
        "    def peek(self):\n"
        "        return self._n  # unguarded-ok: a racy read is fine\n"),
    "contract.py": (
        "import threading\n\n"
        "_taps = []\n\n\n"
        "class Sink:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n\n\n"
        "class Emitter:\n"
        "    def emit(self):\n"
        "        for tap in _taps:\n"
        "            # may-acquire: Sink._lock\n"
        "            tap()\n\n\n"
        "class Caller:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._em = Emitter()\n\n"
        "    def go(self):\n"
        "        with self._lock:\n"
        "            self._em.emit()\n"),
}


def _write(root, files):
    root.mkdir()
    for name, src in files.items():
        (root / name).write_text(src)
    return str(root)


def _findings(an):
    return sorted((d.code, d.op, str(d.severity)) for d in an.report)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = _write(tmp_path_factory.mktemp("fflock") / "corpus",
                  {f"{k}.py": v for k, v in _CORPUS.items()}
                  | _WAIVED)
    return jax_cz.build(root), cz.build(root)


def test_corpus_findings_equal_the_jax_analysis(corpus):
    jax_an, port_an = corpus
    assert _findings(port_an) == _findings(jax_an)
    codes = {c for c, _, _ in _findings(port_an)}
    assert codes == {"FF150", "FF151", "FF152", "FF153", "FF154"}


def test_corpus_graph_and_roster_equal_the_jax_analysis(corpus):
    jax_an, port_an = corpus
    assert port_an.edges == jax_an.edges
    assert port_an.locks == jax_an.locks
    assert ("ABBA._a", "ABBA._b") in port_an.edges
    assert ("ABBA._b", "ABBA._a") in port_an.edges
    # the contract puts the edge the walk cannot see into the graph
    assert ("Caller._lock", "Sink._lock") in port_an.edges


@pytest.mark.parametrize("mod", ["waived_sleep", "waived_field",
                                 "contract"])
def test_waivers_are_honored_as_in_the_jax_analysis(corpus, mod):
    jax_an, port_an = corpus
    mine = [d for d in port_an.report if d.op.startswith(f"corpus/{mod}.")]
    assert mine == [] == [d for d in jax_an.report
                          if d.op.startswith(f"corpus/{mod}.")]


@pytest.mark.parametrize("call,desc", [
    ("torch.cuda.synchronize()", "device sync"),
    ("self._stream.synchronize()", "device sync"),
    ("self._out.cpu()", "device fetch")])
def test_port_blocking_leaves_fire_ff152(tmp_path, call, desc):
    """The port's device sync and fetch under a lock fire FF152, as the
    JAX package's ``block_until_ready``/``device_get`` do; a ``# lock-ok``
    waiver silences them."""
    src = ("import threading\n\n"
           "import torch\n\n\n"
           "class Engine:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n\n"
           "    def step(self):\n"
           "        with self._lock:\n"
           f"            {call}\n\n"
           "    def waived(self):\n"
           "        with self._lock:\n"
           f"            {call}  # lock-ok: no other thread takes it\n")
    an = cz.build(_write(tmp_path / "corpus", {"eng.py": src}))
    hits = [d for d in an.report if d.code == "FF152"]
    assert [(d.op, str(d.severity)) for d in hits] == [
        ("corpus/eng.py:12", "WARN")], an.report.render_text()
    assert desc in hits[0].message and "Engine._lock" in hits[0].message


@pytest.fixture(scope="module")
def tree():
    return cz.build()


def test_port_tree_has_zero_concurrency_errors(tree):
    assert not tree.report.errors, tree.report.render_text()
    assert not list(tree.report), tree.report.render_text()


def test_port_tree_static_graph_is_acyclic(tree):
    assert tree.edges
    assert lockwatch.find_cycle(set(tree.edges)) is None


def test_port_tree_covers_known_locks(tree):
    for lid in ("MicroBatcher._cv", "ServingEngine._lifecycle",
                "GenerationEngine._lifecycle", "FleetEngine._lock",
                "ServingMetrics._lock", "fflogger._capture_lock",
                "_Family._lock", "Tracer._lock",
                "verifier._fallback_lock"):
        assert lid in tree.locks, sorted(tree.locks)
    assert all(m.startswith("flexflow_tpu_torch/") for m in tree.modules)


def test_lint_concurrency_verb_exits_0(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["lint", "--concurrency"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "no diagnostics" in out and "lock-order graph:" in out
    with pytest.raises(SystemExit) as e:
        cli.main(["lint", "--concurrency", "--json"])
    assert e.value.code == 0
    assert json.loads(capsys.readouterr().out)["diagnostics"] == []


def test_runtime_edges_are_static_under_lockwatch(tmp_path):
    """The engines' runtime lock order under ``FF_LOCKWATCH=1`` falls
    inside the static graph, with no cycle."""
    out = tmp_path / "edges.json"
    env = dict(os.environ, FF_LOCKWATCH="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_lockwatch_worker.py"),
         str(out)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rep = json.loads(out.read_text())
    runtime = {tuple(e) for e in rep["runtime"]}
    static = {tuple(e) for e in rep["static"]}
    assert rep["cycle"] is None
    assert len(runtime) >= 10, runtime
    assert not runtime - static, sorted(runtime - static)
    assert {"ServingEngine._lifecycle", "GenerationEngine._lifecycle",
            "MicroBatcher._cv"} <= {x for e in runtime for x in e}
    assert rep["scrape_problems"] == [] and rep["scrape_has_fleet"]
