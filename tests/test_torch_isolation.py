"""The port stands alone: importing flexflow_tpu_torch loads neither jax
nor flexflow_tpu, and no module of the port (nor chip_smoke.py) imports
either of them.  The twins of the example scripts under
``flexflow_tpu_torch/examples/`` are scripts of the runner, not modules:
their ``flexflow_tpu`` imports are names the runner resolves to port
modules (``script_imports.py``), and they are never imported."""

import ast
import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "flexflow_tpu_torch")
SCRIPTS = os.path.join(PKG, "examples")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    return sorted(out)


def _is_script(path: str) -> bool:
    return path.startswith(SCRIPTS + os.sep)


def _modules():
    mods = []
    for path in _port_sources()[1:]:
        if _is_script(path):
            continue
        rel = os.path.relpath(path, REPO)[:-len(".py")]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return mods


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "flexflow_tpu")


def _resolves_to_the_port(name: str) -> bool:
    """A ``flexflow_tpu`` name that the runner resolves to a module of
    the port."""
    from flexflow_tpu_torch.script_imports import port_name
    return (name.split(".")[0] == "flexflow_tpu"
            and importlib.util.find_spec(port_name(name)) is not None)


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in _modules())
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flexflow_tpu'))\n"
              "assert not bad, bad\n"
              "print('isolated', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "isolated" in r.stdout


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_module_imports_jax_or_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)
               and not (_is_script(path) and _resolves_to_the_port(n))]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("module", [
    "flexflow_tpu_torch.ops.attention",
    "flexflow_tpu_torch.ops.cuda_attention",
    "flexflow_tpu_torch.ops.norm", "flexflow_tpu_torch.ops.cuda_norm",
    "flexflow_tpu_torch.ops.elementwise", "flexflow_tpu_torch.ops.linear",
    "flexflow_tpu_torch.ops.tensor_ops",
    "flexflow_tpu_torch.models.transformer",
    "flexflow_tpu_torch.serving.generation.bench",
    "flexflow_tpu_torch.serving.fleet.bench",
    "flexflow_tpu_torch.serving.cluster.bench"])
def test_the_transformer_slice_modules_are_checked(module):
    """The Transformer slice's modules and the serving benches are among
    those the two tests above import and parse."""
    assert module in _modules()
    path = os.path.join(REPO, *module.split(".")) + ".py"
    assert path in _port_sources()


@pytest.mark.parametrize("module", [
    "flexflow_tpu_torch.models.resnet", "flexflow_tpu_torch.models.inception",
    "flexflow_tpu_torch.ops.conv", "flexflow_tpu_torch.ops.cuda_pool"])
def test_the_cnn_slice_modules_are_checked(module):
    """The ResNet-50 and InceptionV3 slice's modules are among those the
    import and parse tests above check."""
    assert module in _modules()
    path = os.path.join(REPO, *module.split(".")) + ".py"
    assert path in _port_sources()


@pytest.mark.parametrize("module", [
    "flexflow_tpu_torch.resilience", "flexflow_tpu_torch.ops.moe",
    "flexflow_tpu_torch.data.dataloader", "flexflow_tpu_torch.model"])
def test_the_training_loop_slice_modules_are_checked(module):
    """The training-loop and checkpoint slice's modules (the port's own
    copy of the checkpoint manifest code among them) are among those the
    import and parse tests above check."""
    assert module in _modules()
    path = os.path.join(REPO, *module.split(".")) + ".py"
    assert path in _port_sources()


@pytest.mark.parametrize("module", [
    "flexflow_tpu_torch.fflogger", "flexflow_tpu_torch.faults",
    "flexflow_tpu_torch.obs", "flexflow_tpu_torch.obs.events",
    "flexflow_tpu_torch.obs.flight", "flexflow_tpu_torch.obs.lockwatch",
    "flexflow_tpu_torch.obs.registry", "flexflow_tpu_torch.obs.trace",
    "flexflow_tpu_torch.serving.metrics",
    "flexflow_tpu_torch.serving.batcher",
    "flexflow_tpu_torch.serving.engine",
    "flexflow_tpu_torch.serving.generation.pages",
    "flexflow_tpu_torch.serving.generation.engine",
    "flexflow_tpu_torch.serving.fleet",
    "flexflow_tpu_torch.serving.fleet.registry",
    "flexflow_tpu_torch.serving.fleet.autoscale",
    "flexflow_tpu_torch.serving.fleet.gate",
    "flexflow_tpu_torch.serving.fleet.engine",
    "flexflow_tpu_torch.serving.cluster",
    "flexflow_tpu_torch.serving.cluster.router",
    "flexflow_tpu_torch.serving.cluster.bench"])
def test_the_fleet_and_cluster_slice_modules_are_checked(module):
    """The serving fleet, disaggregated-serving and event-layer slice's
    modules (the port's own copies of the host-only ``fflogger``,
    ``faults`` and ``obs`` among them) are among those the import and
    parse tests above check."""
    assert module in _modules()
    path = os.path.join(REPO, *module.split("."))
    if os.path.isdir(path):
        path = os.path.join(path, "__init__")
    assert path + ".py" in _port_sources()


def test_faults_never_names_jax():
    """The port's fault switchboard resolves ranks through
    torch.distributed; no line of it names jax."""
    with open(os.path.join(PKG, "faults.py"), encoding="utf-8") as f:
        assert "jax" not in f.read()


@pytest.mark.parametrize("module", [
    "flexflow_tpu_torch.parallel.elastic", "flexflow_tpu_torch.resilience",
    "flexflow_tpu_torch.faults", "flexflow_tpu_torch.model",
    "flexflow_tpu_torch.serving.generation.engine",
    "flexflow_tpu_torch.serving.generation.decoder",
    "flexflow_tpu_torch.serving.generation.pages",
    "flexflow_tpu_torch.analysis.kv_memory",
    "flexflow_tpu_torch.ops.attention"])
def test_the_reshard_and_elastic_slice_modules_are_checked(module):
    """The live-reshard, elastic-supervisor and sharded-generation
    slice's modules (the new ``parallel/elastic.py`` among them) are
    among those the import and parse tests above check."""
    assert module in _modules()
    path = os.path.join(REPO, *module.split(".")) + ".py"
    assert path in _port_sources()


@pytest.mark.parametrize("module", [
    "flexflow_tpu_torch.profiling", "flexflow_tpu_torch.native",
    "flexflow_tpu_torch.search.cost_model",
    "flexflow_tpu_torch.search.simulator",
    "flexflow_tpu_torch.search.session", "flexflow_tpu_torch.search.mcmc",
    "flexflow_tpu_torch.search.decompose",
    "flexflow_tpu_torch.search.hybrid",
    "flexflow_tpu_torch.search.calibration"])
def test_the_search_slice_modules_are_checked(module):
    """The search slice's modules are among those the two tests above
    import and parse."""
    assert module in _modules()
    rel = os.path.join(*module.split("."))
    path = (os.path.join(REPO, rel, "__init__.py")
            if os.path.isdir(os.path.join(REPO, rel))
            else os.path.join(REPO, rel) + ".py")
    assert path in _port_sources()


def test_the_native_simulator_source_is_the_ports_own():
    """The port builds its own copy of the engine (``native/``), never
    the JAX package's library."""
    src = os.path.join(PKG, "native", "simulator.cpp")
    assert os.path.exists(src)
    with open(os.path.join(PKG, "native", "__init__.py")) as f:
        loader = f.read()
    assert "flexflow_tpu.native" not in loader
    assert "flexflow_tpu/native" not in loader


@pytest.mark.parametrize("module", [
    "flexflow_tpu_torch.script_imports", "flexflow_tpu_torch.cli"])
def test_the_examples_slice_modules_are_checked(module):
    """The runner and its import finder are among the modules the two
    tests above import and parse."""
    assert module in _modules()
    path = os.path.join(REPO, *module.split(".")) + ".py"
    assert path in _port_sources()


@pytest.mark.parametrize("rel", [
    "examples/python/native/pipeline_moe_transformer.py",
    "examples/apps/longcontext.py"])
def test_the_twin_scripts_are_parsed_and_never_imported(rel):
    """Each twin is parsed by the import test above (no jax, and only
    ``flexflow_tpu`` names the runner resolves to the port), and is not
    among the modules imported in a plain interpreter."""
    path = os.path.join(PKG, rel)
    assert path in _port_sources()
    assert not any(m.startswith("flexflow_tpu_torch.examples")
                   for m in _modules())


def test_the_c_api_imports_only_the_port_and_numpy():
    """The port's C library is ``capi/flexflow_tpu_c.cpp`` linked with
    its ``PyImport_ImportModule`` wrapped by ``import_port.cpp``: every
    module that source names is numpy or the JAX package's, which the
    wrapper maps onto the port's, and the capi Python modules are among
    those the two tests above import and parse."""
    import re
    from flexflow_tpu_torch.capi import build
    src = os.path.join(REPO, "capi", "flexflow_tpu_c.cpp")
    assert src in build.SOURCES
    assert "-Wl,--wrap=PyImport_ImportModule" in build.LDFLAGS
    with open(src, encoding="utf-8") as f:
        names = re.findall(r'PyImport_ImportModule\("([^"]*)"\)', f.read())
    assert names
    for name in names:
        assert name in ("numpy", "flexflow_tpu") or \
            name.startswith("flexflow_tpu."), name
    with open(os.path.join(PKG, "capi", "import_port.cpp"),
              encoding="utf-8") as f:
        shim = f.read()
    assert '"flexflow_tpu_torch%s"' in shim
    for module in ("flexflow_tpu_torch.capi", "flexflow_tpu_torch.capi.abi",
                   "flexflow_tpu_torch.capi.build",
                   "flexflow_tpu_torch.capi.__main__"):
        assert module in _modules()
