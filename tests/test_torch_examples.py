"""The repo's example scripts through the port's runner.

``python -m flexflow_tpu_torch.cli --device cpu <script> <flags>`` runs
each script of ``tests/test_examples.py`` unchanged, with the same flags
and the same ``slow`` marks: the runner resolves ``flexflow_tpu`` to the
port (``flexflow_tpu_torch/script_imports.py``).  The two scripts that
ask jax for their devices run as their twins
(``flexflow_tpu_torch/examples/``) on eight CPU ranks under the
``elastic`` verb, and the originals fail with the ImportError naming the
twin.  A ``sitecustomize`` on the children's path records, as each
child exits, that no jax module is loaded and that every loaded
``flexflow_tpu*`` module is a file of ``flexflow_tpu_torch/``.

Also here: the two faults the scripts found (``FFModel.forward()``
returned a tensor numpy cannot read; ``MachineMesh()`` ignored the
runner's ``--device``), each held against the JAX package, and the
finder's own guarantees.
"""

import difflib
import glob
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop, script_imports
from flexflow_tpu_torch.parallel import distributed
from tests.subproc import REPO, cached_env

PKG = os.path.join(REPO, "flexflow_tpu_torch")
TOL = 1e-5
BF16_TOL = 2e-2   # the port's bf16 parity tolerance (test_torch_strategies)
ELASTIC_RANKS = 8

# what each script prints when it has done its work (default: fit's
# THROUGHPUT line)
SUCCESS = {"print_layers.py": "logits[0]:", "print_input.py": "logits: shape",
           "tensor_attach.py": "tensor_attach OK",
           "mnist_mlp_attach.py": "epoch 0: accuracy",
           "cifar10_cnn_attach.py": "epoch 0: accuracy"}

# each child writes what it loaded as it exits (test-only: the children
# find this file first on PYTHONPATH)
SITECUSTOMIZE = """\
import atexit
import json
import os
import sys


def _report():
    pkg = os.environ["FF_PORT_PKG"] + os.sep
    mods = list(sys.modules.items())
    rec = {"argv": sys.argv,
           "jax": sorted(n for n, _ in mods
                         if n.split(".")[0] in ("jax", "jaxlib")),
           "outside": sorted(
               n for n, m in mods if n.startswith("flexflow_tpu")
               and not os.path.abspath(
                   getattr(m, "__file__", None) or "?").startswith(pkg))}
    path = os.path.join(os.environ["FF_PORT_REPORTS"], f"{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(rec, f)


atexit.register(_report)
"""


def _run_port(tmp_path, script, *flags, nprocs=0, timeout=600):
    """Run ``script`` through the port's runner (under ``elastic
    --nprocs`` when ``nprocs``); returns (completed process, the
    script's output: its stdout, or every rank's log) after checking
    the children's records."""
    site = tmp_path / "site"
    reports = tmp_path / "reports"
    site.mkdir()
    reports.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    path = script if os.path.isabs(script) else os.path.join(REPO, script)
    env = dict(os.environ, FF_PORT_PKG=PKG, FF_PORT_REPORTS=str(reports),
               TMPDIR=str(tmp_path),
               # ranks share the host's cores (the mesh tests' setting)
               OMP_NUM_THREADS="1" if nprocs else "2",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(site), os.environ.get("PYTHONPATH"))
                   if p))
    cmd = [sys.executable, "-m", "flexflow_tpu_torch.cli"]
    if nprocs:
        cmd += ["elastic", "--nprocs", str(nprocs), "--max-restarts", "0",
                "--workdir", str(tmp_path / "wd"), "--"]
    out = subprocess.run(cmd + ["--device", "cpu", path, *flags],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=timeout)
    text = out.stdout
    if nprocs:   # the supervisor keeps each rank's log under TMPDIR
        text = "".join(open(p).read() for p in sorted(glob.glob(
            str(tmp_path / "ff_elastic_a0_*" / "rank*.log"))))
    recs = [json.loads(p.read_text()) for p in reports.glob("*.json")]
    for rec in recs:
        assert rec["jax"] == [] and rec["outside"] == [], rec
    ran = [rec for rec in recs if rec["argv"][:1] == [path]]
    assert len(ran) == max(nprocs, 1), (recs, out.stderr[-2000:])
    return out, text


def _assert_ran(out, text, script):
    assert out.returncode == 0, (text[-1500:], out.stderr[-3000:])
    assert SUCCESS.get(os.path.basename(script), "THROUGHPUT") in text, \
        text[-1500:]


# ----------------------------------------------------------------------
# tests/test_examples.py, case for case
# ----------------------------------------------------------------------

@pytest.mark.parametrize("script", [
    "examples/python/native/mnist_mlp.py",
    "examples/python/native/mnist_mlp_accum.py",
    "examples/python/native/print_layers.py",
    "examples/python/native/mnist_mlp_attach.py",
    "examples/python/native/tensor_attach.py",
    "examples/python/native/print_input.py",
])
def test_native_example_scripts_run(script, tmp_path):
    out, text = _run_port(tmp_path, script, "-b", "32", "-e", "1")
    _assert_ran(out, text, script)


def test_pipeline_moe_example_runs(tmp_path):
    """The twin of pipeline_moe_transformer.py on eight CPU ranks, one
    process a device: the {n, e, p} mesh, not the one-device smoke."""
    out, text = _run_port(
        tmp_path, os.path.join(
            PKG, "examples/python/native/pipeline_moe_transformer.py"),
        "-b", "8", "-e", "1", nprocs=ELASTIC_RANKS)
    _assert_ran(out, text, "pipeline_moe_transformer.py")
    assert text.count("mesh n2 x e2 x p2") == ELASTIC_RANKS


@pytest.mark.slow  # seq 2048 on eight CPU ranks
def test_longcontext_app_runs_ring_attention(tmp_path):
    out, text = _run_port(
        tmp_path, os.path.join(PKG, "examples/apps/longcontext.py"),
        "-b", "4", "-e", "1", "-ll:tpu", "8", nprocs=ELASTIC_RANKS,
        timeout=900)
    _assert_ran(out, text, "longcontext.py")
    assert text.count("ring attention over s=8") == ELASTIC_RANKS


@pytest.mark.slow  # full 224x224 AlexNet via the torch.nn-style frontend
def test_alexnet_torch_example_runs(tmp_path):
    script = "examples/python/native/alexnet_torch.py"
    _assert_ran(*_run_port(tmp_path, script, "-b", "32", "-e", "1"), script)


@pytest.mark.parametrize("script", [
    "examples/python/keras/seq_mnist_mlp.py",
    "examples/python/keras/unary.py",
    "examples/python/keras/func_mnist_mlp_concat.py",
    "examples/python/keras/seq_reuters_mlp.py",
    "examples/python/keras/candle_uno_keras.py",
    "examples/python/keras/func_mnist_mlp_net2net.py",
    "examples/python/keras/func_mnist_mlp.py",
])
def test_keras_example_scripts_run(script, tmp_path):
    out, text = _run_port(tmp_path, script, "-b", "64", "-e", "2")
    _assert_ran(out, text, script)


@pytest.mark.slow
@pytest.mark.parametrize("script", [
    "examples/python/native/cifar10_cnn.py",
    "examples/python/native/cifar10_cnn_attach.py",
    "examples/python/native/cifar10_cnn_concat.py",
    "examples/python/native/mnist_cnn.py",
    "examples/python/keras/func_cifar10_cnn.py",
    "examples/python/keras/seq_mnist_cnn.py",
    "examples/python/keras/func_cifar10_cnn_nested.py",
    "examples/python/keras/func_cifar10_alexnet.py",
    "examples/python/keras/callback.py",
    "examples/python/keras/func_mnist_cnn.py",
    "examples/python/keras/seq_cifar10_cnn.py",
    "examples/python/keras/func_cifar10_cnn_concat.py",
    "examples/python/keras/func_cifar10_cnn_concat_model.py",
])
def test_cnn_example_scripts_run(script, tmp_path):
    out, text = _run_port(tmp_path, script, "-b", "64", "-e", "4",
                          timeout=1800)
    _assert_ran(out, text, script)


@pytest.mark.slow
@pytest.mark.parametrize("script", [
    "examples/python/native/resnet.py",
    "examples/python/native/inception.py",
])
def test_big_model_example_scripts_run(script, tmp_path):
    out, text = _run_port(tmp_path, script, "-b", "8", "-e", "1",
                          timeout=1800)
    _assert_ran(out, text, script)


# ----------------------------------------------------------------------
# the scripts tests/test_examples.py does not run: full width
# ----------------------------------------------------------------------

@pytest.mark.slow  # full-width models on the CPU
@pytest.mark.parametrize("script", [
    "examples/python/native/alexnet.py",
    "examples/apps/transformer.py",
    "examples/apps/resnet.py",
    "examples/apps/inception.py",
    "examples/apps/dlrm.py",
    "examples/apps/nmt.py",
    "examples/apps/candle_uno.py",
])
def test_full_width_example_scripts_run(script, tmp_path):
    out, text = _run_port(tmp_path, script, "-b", "8", "-e", "1",
                          timeout=1800)
    _assert_ran(out, text, script)


def test_every_example_script_has_a_case():
    """Every script of examples/ runs in a case above, or its twin does
    (``accuracy.py`` is the keras scripts' module of accuracy bounds)."""
    with open(__file__) as f:
        src = f.read()
    for path in sorted(glob.glob(os.path.join(REPO, "examples", "**",
                                              "*.py"), recursive=True)):
        rel = os.path.relpath(path, REPO).replace(os.sep, "/")
        if rel == "examples/python/keras/accuracy.py":
            continue
        assert f'"{rel}"' in src or rel in script_imports.TWINS, rel


# ----------------------------------------------------------------------
# the twins and the jax guard
# ----------------------------------------------------------------------

@pytest.mark.parametrize("rel", script_imports.TWINS)
def test_twin_differs_only_in_the_device_query(rel):
    """The twin changes only the lines that ask jax for the device count
    (to ``world_size()`` of the port's process group) and their
    import."""
    with open(os.path.join(REPO, rel)) as f:
        orig = f.read().splitlines()
    with open(os.path.join(PKG, rel)) as f:
        twin = f.read().splitlines()
    removed = [ln[1:] for ln in difflib.unified_diff(orig, twin, n=0,
                                                     lineterm="")
               if ln.startswith("-") and not ln.startswith("---")]
    added = [ln[1:] for ln in difflib.unified_diff(orig, twin, n=0,
                                                   lineterm="")
             if ln.startswith("+") and not ln.startswith("+++")]
    assert removed and len(removed) == len(added)
    assert all("jax" in ln for ln in removed), removed
    assert [ln for ln in added if "import" in ln] == [
        "    from flexflow_tpu.parallel.distributed import world_size"]
    for old, new in zip(removed, added):
        if "import" not in old:
            assert new == old.replace("len(jax.devices())", "world_size()")
    assert not any("jax" in ln for ln in twin)


@pytest.mark.parametrize("rel", script_imports.TWINS)
def test_jax_querying_original_names_its_twin(rel, tmp_path):
    """Through the port's runner, the original's ``import jax`` raises
    the ImportError that names its twin."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.cli", "--device", "cpu",
         os.path.join(REPO, rel), "-b", "8", "-e", "1"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode != 0
    assert "ImportError: flexflow_tpu_torch runs no JAX" in out.stderr
    assert os.path.join(PKG, rel) in out.stderr.splitlines()[-1]
    assert "THROUGHPUT" not in out.stdout


def test_print_layers_prints_the_jax_packages_names_and_shapes(tmp_path):
    """print_layers.py under both runners: the same summary and the same
    parameter names and shapes (the values differ: each package draws
    its initial weights from its own generator)."""
    script = "examples/python/native/print_layers.py"
    _, port = _run_port(tmp_path, script, "-b", "32", "-e", "1")
    jax = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu.cli",
         os.path.join(REPO, script), "-b", "32", "-e", "1"],
        capture_output=True, text=True, env=cached_env(), cwd=REPO,
        timeout=600)
    assert jax.returncode == 0, jax.stderr[-2000:]

    def shown(text):
        lines = [ln for ln in text.splitlines() if not ln.startswith("{")]
        start = next(i for i, ln in enumerate(lines) if ln.startswith("op "))
        end = next(i for i, ln in enumerate(lines) if ln.startswith("logits"))
        return [re.sub(r" mean=.*", "", ln) for ln in lines[start:end]]

    got = shown(port)
    assert got == shown(jax.stdout)
    assert "dense1/kernel: shape=(64, 784)" in got


# ----------------------------------------------------------------------
# the finder
# ----------------------------------------------------------------------

FINDER_CHECKS = textwrap.dedent("""\
    import importlib, sys
    import flexflow_tpu_torch
    from flexflow_tpu_torch import nn_compat, script_imports
    script_imports.install("x.py")
    import flexflow_tpu as ff
    from flexflow_tpu.keras.datasets import mnist
    from flexflow_tpu.torch import nn
    import flexflow_tpu.torch
    assert ff is flexflow_tpu_torch
    assert ff.FFModel is flexflow_tpu_torch.FFModel
    assert mnist is importlib.import_module(
        "flexflow_tpu_torch.keras.datasets").mnist
    assert nn is nn_compat.nn and ff.torch is nn_compat
    assert flexflow_tpu_torch.__spec__.name == "flexflow_tpu_torch"
    try:
        import flexflow_tpu.compile_cache
    except ModuleNotFoundError as e:
        assert "'flexflow_tpu_torch.compile_cache'" in str(e), e
    else:
        raise AssertionError("no counterpart, but imported")
    try:
        import jax
    except ImportError as e:
        assert "runs no JAX" in str(e) and "twin" not in str(e), e
    else:
        raise AssertionError("jax imported")
    script_imports.uninstall()
    assert not [n for n in sys.modules
                if n == "flexflow_tpu" or n.startswith("flexflow_tpu.")]
    assert not hasattr(flexflow_tpu_torch, "torch")
    assert script_imports.mixing_error() is None
    assert not any(isinstance(f, script_imports.ScriptImports)
                   for f in sys.meta_path)
    print("FINDER_OK")
    """)


def test_finder_hands_back_the_ports_own_modules():
    """``flexflow_tpu`` and its submodules are the port's module objects,
    ``flexflow_tpu.torch`` is ``nn_compat``, a name with no counterpart
    and ``import jax`` fail loudly, and the uninstall leaves no alias;
    in a child with neither package loaded first."""
    out = subprocess.run([sys.executable, "-c", FINDER_CHECKS],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FINDER_OK" in out.stdout


def test_runner_refuses_a_process_that_holds_the_jax_package(tmp_path):
    """The runner in a process where the JAX package is loaded exits 2
    with its message and never runs the script."""
    script = tmp_path / "s.py"
    script.write_text("print('SCRIPT_RAN')\n")
    code = ("import flexflow_tpu\n"
            "from flexflow_tpu_torch.cli import main\n"
            f"main(['--device', 'cpu', {str(script)!r}])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=cached_env(), timeout=300)
    assert out.returncode == 2
    assert "JAX package is already imported" in out.stderr
    assert "SCRIPT_RAN" not in out.stdout


def test_port_names_follow_the_dotted_path():
    assert script_imports.port_name("flexflow_tpu") == "flexflow_tpu_torch"
    assert script_imports.port_name("flexflow_tpu.keras.datasets") == \
        "flexflow_tpu_torch.keras.datasets"
    assert script_imports.port_name("flexflow_tpu.torch.nn") == \
        "flexflow_tpu_torch.nn_compat.nn"
    assert script_imports.port_name("flexflow_tpu.torchy") == \
        "flexflow_tpu_torch.torchy"
    for rel in script_imports.TWINS:
        assert script_imports.twin_of(os.path.join(REPO, rel)) == \
            os.path.join(PKG, rel)
    assert script_imports.twin_of("examples/apps/transformer.py") is None


# ----------------------------------------------------------------------
# the two repairs
# ----------------------------------------------------------------------

def _print_layers_graph(pkg, dtype, device=None):
    """print_layers.py's graph: Dense 784->64 relu, Dense 64->10."""
    cfg = pkg.FFConfig(batch_size=16, compute_dtype=dtype)
    model = (pkg.FFModel(cfg) if device is None
             else pkg.FFModel(cfg, device=device))
    x = model.create_tensor((16, 784), name="input")
    t = model.dense(x, 64, activation="relu", name="dense1")
    t = model.dense(t, 10, name="dense2")
    model.compile(pkg.SGDOptimizer(lr=0.01),
                  pkg.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  [pkg.METRICS_ACCURACY], final_tensor=t)
    model.init_layers(seed=0)
    return model


def test_forward_reads_in_numpy_and_equals_the_jax_forward():
    """``np.asarray(model.forward())``, as print_layers.py, print_input.py
    and tensor_attach.py call it: float32 within 1e-5 of the JAX
    package's forward in float32, and float32 within the bf16 tolerance
    in bf16 (the exact upcast of the port's bf16 output)."""
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((16, 784)).astype(np.float32)
    yb = rng.integers(0, 10, (16, 1)).astype(np.int32)
    for dtype, tol in (("float32", TOL), ("bfloat16", BF16_TOL)):
        jm = _print_layers_graph(ff, dtype)
        pm = _print_layers_graph(ft, dtype, device="cpu")
        interop.params_from_jax_numpy(
            pm, {p.name: np.asarray(jm.get_weights(p.name))
                 for p in jm.parameters})
        jm.set_batch(xb, yb)
        pm.set_batch(xb, yb)
        got = np.asarray(pm.forward())
        want = np.asarray(jm.forward()).astype(np.float32)
        assert got.dtype == np.float32, (dtype, got.dtype)
        assert got.shape == want.shape == (16, 10)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=dtype)


def test_machine_mesh_follows_the_default_device(monkeypatch):
    """``MachineMesh()`` in one process takes the runner's ``--device``
    (``set_default_device``); with no default and no card it raises, as
    it did."""
    monkeypatch.setitem(distributed._RUNTIME, "device_type", None)
    ft.set_default_device("cpu")
    try:
        assert ft.MachineMesh({"p": 1}).device == torch.device("cpu")
    finally:
        ft.set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ft.MachineMesh({"p": 1})
