"""The C API over the port (``flexflow_tpu_torch/capi/``) against the
JAX package's (``capi/``), on the CPU.

* The port's library is ``capi/flexflow_tpu_c.cpp``, unchanged, whose
  imports ``import_port.cpp`` maps onto the port, under the same header
  byte for byte; its ``test_capi.c`` twin differs only in its two
  ``/tmp`` paths, made relative to the host's working directory.
* The twin, built against the port's library, runs end to end in a C
  host whose embedded interpreter cannot import jax or the JAX package
  (a ``sitecustomize`` on its ``PYTHONPATH`` refuses them), and
  ``capi/examples/alexnet.c`` runs unchanged (slow).
* In this process, through the C functions (``ctypes.PyDLL``), the MLP,
  transformer block and LSTM pair of ``test_capi.c`` train in float32
  from the JAX package's weights: three ``train_batch`` losses and the
  verb sequence's loss and weights within 1e-5 of the JAX package's
  Python API on the same seeded buffers.
* Checkpoints, strategy export and import, and the error paths behave
  as the JAX package's; a host buffer rewritten between ``set_batch``
  and ``forward`` gives the JAX package's forward (both copy it).
* ``FLEXFLOW_PLATFORM`` picks the port's default device at import.
"""

import ctypes
import difflib
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import time

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu.strategy import proto as jax_proto
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.capi import abi, build
from tests.subproc import REPO, cached_env

CAPI = os.path.join(REPO, "capi")
PORT_CAPI = os.path.join(REPO, "flexflow_tpu_torch", "capi")
TOL = 1e-5
HOST_LINES = ("MLP OK", "transformer OK", "lstm OK", "C API OK")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not os.path.exists(os.path.join(
        sysconfig.get_config_var("INCLUDEPY") or "", "Python.h")),
    reason="no native toolchain (g++ and Python.h)")

# the C host's embedded interpreter finds this first on PYTHONPATH: any
# import of jax, jaxlib or the JAX package fails (test-only)
SITECUSTOMIZE = """\
import sys


class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flexflow_tpu"):
            raise ModuleNotFoundError(f"the C host may not import {name}")
        return None


sys.meta_path.insert(0, _NoJax())
print("import guard on", file=sys.stderr)
"""


def _host_env(tmp_path):
    site_dir = tmp_path / "site"
    site_dir.mkdir()
    (site_dir / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = build.host_env(cached_env())
    env["PYTHONPATH"] = os.pathsep.join((str(site_dir), env["PYTHONPATH"]))
    return env


def _run_host(tmp_path, c_source, name, *args, timeout=600):
    host = build.build_host(c_source, name)
    t0 = time.perf_counter()
    out = subprocess.run([host, *args], capture_output=True, text=True,
                         env=_host_env(tmp_path), cwd=str(tmp_path),
                         timeout=timeout)
    secs = time.perf_counter() - t0
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert "import guard on" in out.stderr
    assert "not writable" not in out.stderr, out.stderr[-2000:]
    return out.stdout, secs


def test_port_test_capi_runs_in_a_c_host_without_jax(tmp_path):
    text, _ = _run_host(tmp_path, os.path.join(PORT_CAPI, "test_capi.c"),
                        "test_capi")
    assert all(line in text for line in HOST_LINES), text


def test_module_check_runs_test_capi_in_a_temporary_directory(tmp_path):
    """``python -m flexflow_tpu_torch.capi --check`` builds and runs the
    twin, whose relative checkpoint and strategy paths land in a
    directory of its own, not in the caller's."""
    env = build.host_env(cached_env())
    out = subprocess.run([sys.executable, "-m", "flexflow_tpu_torch.capi",
                          "--check"], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert all(line in out.stdout for line in HOST_LINES), out.stdout
    assert "link a host: gcc" in out.stdout
    assert os.listdir(tmp_path) == []


@pytest.mark.slow
def test_capi_alexnet_example_runs_on_the_port(tmp_path):
    text, secs = _run_host(tmp_path,
                           os.path.join(CAPI, "examples", "alexnet.c"),
                           "alexnet", "-b", "8", "-e", "1", timeout=900)
    assert "THROUGHPUT" in text, text
    loss = float(re.search(r"final loss (\S+)", text).group(1))
    assert np.isfinite(loss)
    print(f"alexnet.c -b 8 -e 1 through the port: {secs:.1f} s")


# ----------------------------------------------------------------------
# the sources
# ----------------------------------------------------------------------

def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read().splitlines()


def _changes(old_path, new_path):
    """(old lines, new lines) of each block that differs."""
    old, new = _read(old_path), _read(new_path)
    sm = difflib.SequenceMatcher(a=old, b=new, autojunk=False)
    return [(old[i1:i2], new[j1:j2])
            for tag, i1, i2, j1, j2 in sm.get_opcodes() if tag != "equal"]


def test_header_is_byte_equal_to_capi():
    with open(os.path.join(CAPI, "flexflow_tpu_c.h"), "rb") as a, \
            open(os.path.join(PORT_CAPI, "flexflow_tpu_c.h"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name,want", [
    ("flexflow_tpu", "flexflow_tpu_torch"),
    ("flexflow_tpu.strategy.proto", "flexflow_tpu_torch.strategy.proto"),
    ("numpy", "numpy")])
def test_library_imports_go_to_the_port(lib, name, want):
    """``capi/flexflow_tpu_c.cpp``'s ``PyImport_ImportModule`` calls,
    wrapped at link time, import the port's module where they name the
    JAX package's, and any other module as named."""
    imp = lib.__wrap_PyImport_ImportModule
    imp.restype = ctypes.py_object
    imp.argtypes = [ctypes.c_char_p]
    assert imp(name.encode()) is sys.modules[want]


def test_library_imports_leave_a_longer_name_alone(lib):
    """Only ``flexflow_tpu`` and its dotted submodules are mapped: a name
    that merely starts with it is imported as given."""
    imp = lib.__wrap_PyImport_ImportModule
    imp.restype = ctypes.py_object
    imp.argtypes = [ctypes.c_char_p]
    with pytest.raises(ModuleNotFoundError, match="'flexflow_tpux'"):
        imp(b"flexflow_tpux")


def test_test_capi_twin_differs_in_its_tmp_paths_only():
    changes = _changes(os.path.join(CAPI, "test_capi.c"),
                       os.path.join(PORT_CAPI, "test_capi.c"))
    paths = {"/tmp/capi_ckpt": "capi_torch_ckpt",
             "/tmp/capi_strategy.pb": "capi_torch_strategy.pb"}
    seen = set()
    for old, new in changes:
        assert len(old) == len(new)
        for a, b in zip(old, new):
            got = [p for p in paths if f'"{p}"' in a]
            assert len(got) == 1, a
            assert b == a.replace(got[0], paths[got[0]])
            seen.add(got[0])
    assert seen == set(paths)


# ----------------------------------------------------------------------
# in this process, through the C functions
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def lib():
    lib = abi.load()
    assert lib.flexflow_init() == 0, abi.last_error(lib)
    return lib


@pytest.fixture(autouse=True)
def _cpu():
    ft.set_default_device("cpu")
    yield
    ft.set_default_device(None)


# (config flags, inputs, label) of each of test_capi.c's graphs, float32
GRAPHS = {
    "mlp": (("-b", "16", "-e", "1"), [((16, 8), "float32")],
            ((16,), 4)),
    "transformer": (("-b", "8"), [((8, 8), 64)], ((8,), 4)),
    "lstm": (("-b", "8"), [((8, 6), 32)], ((8, 6), 32)),
}
F32 = ("--compute-dtype", "float32")


def _c_graph(lib, kind, strategy_file=""):
    """``test_capi.c``'s graph through the C functions: (model, config,
    optimizer) handles, compiled (after importing ``strategy_file``,
    if given) and initialized."""
    cfg = abi.config(lib, *GRAPHS[kind][0], *F32)
    ck = lambda h, what: abi.check(lib, h, what)
    opt = None
    if kind == "transformer":
        m, out = abi.transformer_block(lib, cfg, 8, 8, 16, 2, 32, 64, 4)
        opt = ck(lib.flexflow_adam_optimizer_create(0.01, 0.9, 0.999, 0.0,
                                                    1e-8), "adam")
    elif kind == "mlp":
        m = ck(lib.flexflow_model_create(cfg), "model")
        x = ck(lib.flexflow_model_create_tensor(m, 2, abi.dims(16, 8),
                                                abi.FF_DT_FLOAT, b"x"), "x")
        t = ck(lib.flexflow_model_dense(m, x, 32, abi.FF_AC_RELU, 1,
                                        b"fc1"), "fc1")
        lg = ck(lib.flexflow_model_dense(m, t, 4, abi.FF_AC_NONE, 1,
                                         b"fc2"), "fc2")
        out = ck(lib.flexflow_model_softmax(m, lg, b"softmax"), "softmax")
    else:
        m = ck(lib.flexflow_model_create(cfg), "model")
        src = ck(lib.flexflow_model_create_tensor(m, 2, abi.dims(8, 6),
                                                  abi.FF_DT_INT32, b"src"),
                 "src")
        emb = ck(lib.flexflow_model_embedding(m, src, 32, 16, b"none",
                                              b"src_embed"), "src_embed")
        hf, cf = abi.H(), abi.H()
        ck(lib.flexflow_model_lstm(m, emb, 16, None, None, ctypes.byref(hf),
                                   ctypes.byref(cf), b"enc"), "enc")
        seq = ck(lib.flexflow_model_lstm(m, emb, 16, hf, cf, None, None,
                                         b"dec"), "dec")
        out = ck(lib.flexflow_model_dense(m, seq, 32, abi.FF_AC_NONE, 1,
                                          b"vocab_proj"), "vocab_proj")
        opt = ck(lib.flexflow_sgd_optimizer_create(0.1, 0.9, 0, 0.0), "sgd")
    if strategy_file:
        assert lib.flexflow_model_import_strategies(
            m, strategy_file.encode()) == 0, abi.last_error(lib)
    if opt is None:
        rc = lib.flexflow_model_compile(m, abi.FF_OPT_SGD, 0.1,
                                        abi.FF_LOSS_SPARSE_CCE, out)
    else:
        rc = lib.flexflow_model_compile_opt(m, opt, abi.FF_LOSS_SPARSE_CCE,
                                            out)
    assert rc == 0 and lib.flexflow_model_init_layers(m, 0) == 0, \
        abi.last_error(lib)
    return m, cfg, opt


def _jax_graph(kind, strategy_file=""):
    """The same graph through the JAX package's Python API, with the
    calls the JAX C layer makes."""
    cfg = ff.FFConfig.parse_args([*GRAPHS[kind][0], *F32])
    cfg.import_strategy_file = strategy_file
    m = ff.FFModel(cfg)
    if kind == "transformer":
        tok = m.create_tensor((8, 8), "int32", "tokens")
        emb = m.embedding(tok, 64, 16, aggr="none", name="tok_embed")
        pos = m.position_embedding(emb, name="pos_embed")
        attn = m.multihead_attention(pos, embed_dim=16, num_heads=2,
                                     dropout=0.0, bias=True, causal=True,
                                     name="attn")
        ln1 = m.layer_norm(m.add(pos, attn, name="res1"), name="ln1")
        up = m.dense(ln1, 32, activation="gelu", use_bias=True,
                     name="ffn_up")
        dn = m.dense(up, 16, use_bias=True, name="ffn_down")
        ln2 = m.layer_norm(m.add(ln1, dn, name="res2"), name="ln2")
        fl = m.reshape(ln2, (8, 128), name="fl")
        out = m.dense(fl, 4, use_bias=True, name="cls")
        opt = ff.AdamOptimizer(alpha=0.01, beta1=0.9, beta2=0.999,
                               weight_decay=0.0, epsilon=1e-8)
    elif kind == "mlp":
        x = m.create_tensor((16, 8), "float32", "x")
        t = m.dense(x, 32, activation="relu", use_bias=True, name="fc1")
        lg = m.dense(t, 4, use_bias=True, name="fc2")
        out = m.softmax(lg, name="softmax")
        opt = ff.SGDOptimizer(lr=0.1)
    else:
        src = m.create_tensor((8, 6), "int32", "src")
        emb = m.embedding(src, 32, 16, aggr="none", name="src_embed")
        _, h, c = m.lstm(emb, 16, name="enc")
        seq, _, _ = m.lstm(emb, 16, initial_state=(h, c), name="dec")
        out = m.dense(seq, 32, use_bias=True, name="vocab_proj")
        opt = ff.SGDOptimizer(lr=0.1, momentum=0.9, nesterov=False,
                              weight_decay=0.0)
    m.compile(opt, "sparse_categorical_crossentropy", final_tensor=out)
    m.init_layers(0)
    return m


def _batch(kind, seed):
    """Seeded host buffers: the inputs, then the label."""
    rng = np.random.default_rng(seed)
    _, inputs, (lshape, classes) = GRAPHS[kind]
    xs = [rng.standard_normal(shape).astype(np.float32)
          if high == "float32" else
          rng.integers(0, high, shape).astype(np.int32)
          for shape, high in inputs]
    return xs, rng.integers(0, classes, lshape).astype(np.int32)


def _c_weights(lib, m, name):
    n = lib.flexflow_model_get_weights(m, name.encode(), None, 0)
    assert n > 0, abi.last_error(lib)
    buf = np.empty(n, np.float32)
    got = lib.flexflow_model_get_weights(
        m, name.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n)
    assert got == n, abi.last_error(lib)
    return buf


def _set_c_weights(lib, m, name, value):
    w = np.ascontiguousarray(value, np.float32).ravel()
    rc = lib.flexflow_model_set_weights(
        m, name.encode(), w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w.size)
    assert rc == 0, abi.last_error(lib)


def _carried(lib, kind):
    """The graph in both packages, the JAX weights carried into the
    port's through ``flexflow_model_set_weights``."""
    jm = _jax_graph(kind)
    m, cfg, opt = _c_graph(lib, kind)
    names = sorted(p.name for p in jm.parameters)
    assert names == sorted(p.name for p in abi.py_object(m).parameters)
    for name in names:
        _set_c_weights(lib, m, name, jm.get_weights(name))
    return jm, m, names


def _close(got, want):
    return abs(got - want) <= TOL * max(1.0, abs(want))


@pytest.mark.parametrize("kind", list(GRAPHS))
def test_c_abi_trains_as_the_jax_package(lib, kind):
    jm, m, names = _carried(lib, kind)
    for step in range(3):
        xs, y = _batch(kind, step)
        got = lib.flexflow_model_train_batch(m, len(xs), abi.batch(*xs),
                                             y.ctypes.data)
        want = float(jm.train_batch(*xs, y))
        assert _close(got, want), (kind, step, got, want,
                                   abi.last_error(lib))
    xs, y = _batch(kind, 3)
    assert lib.flexflow_model_set_batch(m, len(xs), abi.batch(*xs),
                                        y.ctypes.data) == 0
    for verb in ("forward", "zero_gradients"):
        assert getattr(lib, f"flexflow_model_{verb}")(m) == 0
    got = lib.flexflow_model_backward(m)
    assert lib.flexflow_model_update(m) == 0, abi.last_error(lib)
    jm.set_batch(*xs, y)
    jm.forward()
    jm.zero_gradients()
    want = float(jm.backward())
    jm.update()
    assert _close(got, want), (kind, got, want)
    for name in names:
        w = np.asarray(jm.get_weights(name), np.float32).ravel()
        c = _c_weights(lib, m, name)
        assert np.abs(c - w).max() <= TOL * max(1.0, np.abs(w).max()), name
    lib.flexflow_model_destroy(m)


def test_host_buffer_rewritten_after_set_batch_as_in_jax(lib):
    """The JAX package's ``set_batch`` copies the host array the C layer
    wraps (read-only, over the host's buffer); the port's copies it too,
    so a buffer rewritten before ``forward`` changes neither."""
    jm, m, _ = _carried(lib, "mlp")
    (x,), y = _batch("mlp", 0)
    (x2,), _ = _batch("mlp", 1)
    host = bytearray(x.tobytes())
    view = np.frombuffer(memoryview(host).toreadonly(), np.float32)
    jm.set_batch(view.reshape(x.shape), y)
    host[:] = x2.tobytes()
    want = np.asarray(jm.forward())
    want_loss = float(jm.backward())
    jm.set_batch(x2, y)
    assert not np.allclose(want, np.asarray(jm.forward()))

    buf = x.copy()
    assert lib.flexflow_model_set_batch(m, 1, abi.batch(buf),
                                        y.ctypes.data) == 0
    buf[...] = x2
    assert lib.flexflow_model_forward(m) == 0
    got = abi.py_object(m).forward().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert _close(lib.flexflow_model_backward(m), want_loss)


def test_checkpoint_round_trip_and_the_jax_package_loads_it(lib, tmp_path):
    jm, m, names = _carried(lib, "transformer")
    xs, y = _batch("transformer", 0)
    lib.flexflow_model_train_batch(m, 1, abi.batch(*xs), y.ctypes.data)
    path = str(tmp_path / "ckpt")
    assert lib.flexflow_model_save_checkpoint(m, path.encode()) == 0
    saved = {n: _c_weights(lib, m, n) for n in names}
    _set_c_weights(lib, m, "cls/kernel", np.full(saved["cls/kernel"].size,
                                                 -9.0, np.float32))
    assert lib.flexflow_model_load_checkpoint(m, path.encode()) == 0
    for n in names:
        np.testing.assert_array_equal(_c_weights(lib, m, n), saved[n])
    jm.load_checkpoint(path)
    for n in names:
        np.testing.assert_array_equal(
            np.asarray(jm.get_weights(n), np.float32).ravel(), saved[n])


def test_strategy_import_and_export_as_in_the_jax_package(lib, tmp_path):
    """A strategy file imported through the C layer before compile
    reaches the ops, and the C layer's export of them reads in the JAX
    package as the JAX package's own export of the same graph."""
    imported = str(tmp_path / "in.pb")
    jax_proto.save_strategy_file(imported, {
        "ffn_up": ff.ParallelConfig(dims=(1, 1, 1), device_ids=(0,)),
        "cls": ff.ParallelConfig(dims=(1, 1), device_ids=(0,),
                                 precision="f32")})
    jm = _jax_graph("transformer", imported)
    m, _, _ = _c_graph(lib, "transformer", imported)
    port = str(tmp_path / "port.pb")
    assert lib.flexflow_model_export_strategies(m, port.encode()) == 0
    jax_pb = str(tmp_path / "jax.pb")
    jax_proto.save_strategy_file(jax_pb, {
        op.name: op.parallel_config for op in jm.layers
        if op.parallel_config})
    got = jax_proto.load_strategy_file(port)
    want = jax_proto.load_strategy_file(jax_pb)
    assert sorted(got) == sorted(want) == ["cls", "ffn_up"]
    assert got == want


def test_import_strategies_sets_the_config_field(lib):
    m, _, _ = _c_graph(lib, "mlp")
    assert lib.flexflow_model_import_strategies(m, b"/x/strategy.pb") == 0
    assert abi.py_object(m).config.import_strategy_file == "/x/strategy.pb"


def _error_calls(lib, m, tmp_path):
    (x,), y = _batch("mlp", 0)
    nan = float("nan")
    return {
        "get_weights of a missing name": (
            lambda: lib.flexflow_model_get_weights(m, b"fc9/kernel", None,
                                                   0), -1),
        "train_batch with two inputs": (
            lambda: lib.flexflow_model_train_batch(m, 2, abi.batch(x, x),
                                                   y.ctypes.data), nan),
        "set_batch with no input": (
            lambda: lib.flexflow_model_set_batch(m, 0, abi.batch(),
                                                 y.ctypes.data), -1),
        "load_checkpoint of no file": (
            lambda: lib.flexflow_model_load_checkpoint(
                m, str(tmp_path / "none.npz").encode()), -1),
        "export_strategies into no directory": (
            lambda: lib.flexflow_model_export_strategies(
                m, str(tmp_path / "no" / "s.pb").encode()), -1),
        "backward before set_batch": (
            lambda: lib.flexflow_model_backward(m), nan),
    }


@pytest.mark.parametrize("call", [
    "get_weights of a missing name", "train_batch with two inputs",
    "set_batch with no input", "load_checkpoint of no file",
    "export_strategies into no directory", "backward before set_batch"])
def test_a_failed_call_reports_and_the_next_succeeds(lib, tmp_path, call):
    """A failed call returns -1 or NaN with ``flexflow_last_error`` set
    and no Python exception left pending (PyDLL would raise it), and
    the next call succeeds."""
    m, _, _ = _c_graph(lib, "mlp")
    fn, bad = _error_calls(lib, m, tmp_path)[call]
    got = fn()
    assert (np.isnan(got) if np.isnan(bad) else got == bad), got
    assert abi.last_error(lib)
    (x,), y = _batch("mlp", 0)
    loss = lib.flexflow_model_train_batch(m, 1, abi.batch(x), y.ctypes.data)
    assert np.isfinite(loss), abi.last_error(lib)


# ----------------------------------------------------------------------
# FLEXFLOW_PLATFORM
# ----------------------------------------------------------------------

def _child(code, platform=None, args=()):
    env = {k: v for k, v in os.environ.items() if k != "FLEXFLOW_PLATFORM"}
    if platform is not None:
        env["FLEXFLOW_PLATFORM"] = platform
    return subprocess.run([sys.executable, *(["-c", code] if code else []),
                           *args], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)


@pytest.mark.parametrize("platform,device", [
    ("cpu", "cpu"), ("cuda", "cuda"), ("gpu", "cuda"), (None, None),
    ("", None)])
def test_flexflow_platform_sets_the_default_device(platform, device):
    out = _child("import flexflow_tpu_torch as ft; "
                 "print(repr(ft.get_default_device()))", platform)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == repr(device)


def test_flexflow_platform_refuses_another_value():
    out = _child("import flexflow_tpu_torch", "tpu")
    assert out.returncode != 0
    assert "ImportError: FLEXFLOW_PLATFORM='tpu'" in out.stderr
    assert "'cpu' or 'cuda'" in out.stderr


SCRIPT = """\
import flexflow_tpu_torch as ft
cfg = ft.FFConfig(batch_size=4, compute_dtype="float32")
m = ft.FFModel(cfg)
x = m.create_tensor((4, 3), "float32", "x")
m.compile(ft.SGDOptimizer(lr=0.1), "mean_squared_error",
          final_tensor=m.dense(x, 2, name="d"))
m.init_layers(seed=0)
print("device", ft.get_default_device(), m.device)
"""


@pytest.mark.parametrize("platform,flags", [("cuda", ["--device", "cpu"]),
                                            ("cpu", [])])
def test_runner_takes_its_device_flag_then_flexflow_platform(
        tmp_path, platform, flags):
    script = tmp_path / "s.py"
    script.write_text(SCRIPT)
    out = _child(None, platform, ["-m", "flexflow_tpu_torch.cli", *flags,
                                  str(script)])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "device cpu cpu" in out.stdout
