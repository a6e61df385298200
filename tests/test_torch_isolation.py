"""The port stands alone: importing flexflow_tpu_torch loads neither jax
nor flexflow_tpu, and no module of the port (nor chip_smoke.py) imports
either of them."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "flexflow_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_sources()[1:]:
        rel = os.path.relpath(path, REPO)[:-len(".py")]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return mods


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "flexflow_tpu")


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
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("module", [
    "flexflow_tpu_torch.ops.attention",
    "flexflow_tpu_torch.ops.cuda_attention",
    "flexflow_tpu_torch.ops.norm", "flexflow_tpu_torch.ops.cuda_norm",
    "flexflow_tpu_torch.ops.elementwise", "flexflow_tpu_torch.ops.linear",
    "flexflow_tpu_torch.ops.tensor_ops",
    "flexflow_tpu_torch.models.transformer"])
def test_the_transformer_slice_modules_are_checked(module):
    """The Transformer slice's modules are among those the two tests
    above import and parse."""
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
