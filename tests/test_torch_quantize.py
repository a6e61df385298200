"""Int8 weight-only serving in the port against the JAX package's, on
the CPU, in float32.

``quantize_array`` is the same numpy function in both packages, so its
``q``, ``scale``, error and bound must be bit-equal (magnitudes 1e-3, 1
and 37.5, a zero row, exact .5 ties, a row whose max is subnormal); so
must ``quantize_params``' report and ``quantized_params_bytes_delta``.
The quantized MLP and small Transformer ``predict`` (JAX weights carried
across) agree with the JAX quantized ``predict`` within rtol 1e-5 / atol
1e-6, and the quantized ``ServingEngine`` returns the port's quantized
``predict`` bit for bit.  The guards (``fit``, ``train_batch``,
``train_window``, ``evaluate``, ``save_checkpoint`` raise RuntimeError
"quantized"), the tampered report refused at warm-up, the idempotent
call, the float32 kernels released, and ``precision_policy`` follow the
JAX package's ``tests/test_precision.py``.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.config import ParallelConfig as JaxParallelConfig
from flexflow_tpu.models import build_transformer as jax_build_transformer
from flexflow_tpu.parallel.mesh import AbstractMesh as JaxAbstractMesh
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.serving import quantize as jquant
from flexflow_tpu.serving.engine import ServingEngine as JaxServingEngine
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.config import DeviceType, ParallelConfig
from flexflow_tpu_torch.ops.common import dequant_matmul, scale_param_name
from flexflow_tpu_torch.parallel.mesh import AbstractMesh
from flexflow_tpu_torch.serving import ServingEngine
from flexflow_tpu_torch.serving import quantize as tquant

RTOL, ATOL = 1e-5, 1e-6
TF = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, seq_len=16,
          vocab_size=100)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


def _same(a, b):
    """q, scale, err, bound of both packages bit-equal."""
    for x, y in zip(a[:2], b[:2]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(_bits(x), _bits(y))
    assert a[2] == b[2] and a[3] == b[3]


# ---------------------------------------------------------------------
# quantize_array, quantize_params, the bytes delta
# ---------------------------------------------------------------------
@pytest.mark.parametrize("mag", [1e-3, 1.0, 37.5])
def test_quantize_array_bit_equal_to_jax(mag):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 48)) * mag).astype(np.float32)
    w[3] = 0.0                                   # a zero row
    # exact .5 ties: with s a power of two near the magnitude, a row
    # max of 127 * s makes the scale exactly s and k.5 * s divides back
    # to k.5 exactly, so np.rint rounds to even
    s = np.float32(2.0 ** np.floor(np.log2(mag)) / 128.0)
    w[5] = 0.0
    w[5, 0] = 127 * s
    w[5, 1:9] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5],
                         np.float32) * s
    # a row whose max is subnormal: the scale sits at float32 tiny
    w[7] = 0.0
    w[7, :3] = np.array([1e-40, -3e-41, 5e-42], np.float32)
    got = tquant.quantize_array(w)
    want = jquant.quantize_array(w)
    _same(got, want)
    q, scale, err, bound = got
    assert np.all(q[3] == 0) and np.all(q[7] == 0)
    assert scale[7] == np.finfo(np.float32).tiny
    # ties to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 3.5 -> 4, 126.5 -> 126
    assert list(q[5, :9]) == [127, 0, 2, 2, 0, -2, -2, 4, 126]
    assert err <= bound and np.max(np.abs(q)) <= tquant.INT8_QMAX


def test_quantize_array_edge_shapes_bit_equal():
    for w in (np.zeros((4, 8), np.float32), np.zeros((3, 0), np.float32),
              np.full((2, 5), 1e9, np.float32)):
        _same(tquant.quantize_array(w), jquant.quantize_array(w))


def _mlp(pkg, quantize="", strategies=None):
    cfg = pkg.FFConfig(batch_size=4, compute_dtype="float32", seed=0,
                       serve_quantize=quantize)
    if strategies:
        cfg.strategies.update(strategies)
    if pkg is ff:
        m = ff.FFModel(cfg, mesh=MachineMesh({"n": 1}))
    else:
        m = ft.FFModel(cfg, device="cpu")
    t = m.create_tensor((4, 32), name="x")
    t = m.dense(t, 32, activation="relu", name="d1")
    t = m.dense(t, 3, name="d2")
    m.softmax(t, name="head")
    kw = {"verify": "off"}
    m.compile(pkg.SGDOptimizer(lr=0.1),
              loss_type="sparse_categorical_crossentropy", **kw)
    m.init_layers(seed=0)
    return m


def _transformer(pkg, quantize=""):
    cfg = pkg.FFConfig(batch_size=4, compute_dtype="float32", seed=0,
                       serve_quantize=quantize)
    if pkg is ff:
        m = jax_build_transformer(cfg, **TF)[0]
        m.compile(ff.SGDOptimizer(lr=0.01), mesh=MachineMesh({"n": 1}))
    else:
        m = ft.build_transformer(cfg, device="cpu", **TF)[0]
        m.compile(ft.SGDOptimizer(lr=0.01))
    m.init_layers(seed=0)
    return m


def _pair(build, **kw):
    jm = build(ff, **kw)
    tm = build(ft, **kw)
    interop.params_from_jax_numpy(
        tm, {p.name: jm.get_weights(p.name) for p in jm.parameters})
    return jm, tm


@pytest.fixture(scope="module")
def mlp_pair():
    return _pair(_mlp, quantize="int8")


@pytest.fixture(scope="module")
def tf_pair():
    return _pair(_transformer, quantize="int8")


def _x(n=12):
    return np.random.default_rng(0).standard_normal((n, 32)).astype(
        np.float32)


def _tokens(n=8):
    return np.random.default_rng(1).integers(
        0, TF["vocab_size"], (n, TF["seq_len"])).astype(np.int32)


@pytest.mark.parametrize("which", ["mlp", "transformer"])
def test_quantize_params_report_equals_jax(which):
    build = _mlp if which == "mlp" else _transformer
    jm, tm = _pair(build)
    assert (tquant.eligible_weight_names(tm.layers)
            == jquant.eligible_weight_names(jm.layers))
    _, jrep = jquant.quantize_params(jm, "int8")
    tparams, trep = tquant.quantize_params(tm, "int8")
    assert trep == jrep
    assert trep["bound_ok"] and trep["weights"]
    assert trep["bytes_after"] < trep["bytes_before"] / 2
    for row in trep["weights"]:
        q = tparams[row["weight"]]
        s = tparams[scale_param_name(row["weight"])]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert tuple(q.shape) == tuple(row["shape"])
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tquant.quantize_params(tm, "int4")


@pytest.mark.parametrize("shape,strategies", [
    ({"n": 1}, {}),
    ({"n": 2, "c": 2}, {"d1": (1, 2), "d2": (2, 1)}),
    ({"n": 1, "c": 4}, {"d1": (1, 4)}),
    ({"n": 1, "c": 6}, {"d1": (1, 3), "d2": (1, 6)}),
])
def test_quantized_params_bytes_delta_equals_jax(shape, strategies):
    jm, tm = _mlp(ff), _mlp(ft)
    jstr = {k: JaxParallelConfig(dims=v) for k, v in strategies.items()}
    tstr = {k: ParallelConfig(dims=v) for k, v in strategies.items()}
    want = jquant.quantized_params_bytes_delta(jm.layers, jstr,
                                               JaxAbstractMesh(shape))
    got = tquant.quantized_params_bytes_delta(tm.layers, tstr,
                                              AbstractMesh(shape))
    assert got == want and got < 0


def test_host_placed_linear_is_not_eligible():
    m = _mlp(ft)
    m.layers[0].parallel_config = ParallelConfig(
        dims=(1, 1), device_type=DeviceType.HOST)
    assert tquant.eligible_weight_names(m.layers) == {"d2/kernel"}


# ---------------------------------------------------------------------
# the quantized forward
# ---------------------------------------------------------------------
def test_dequant_matmul_is_the_product_then_the_scale():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    q, scale, _, _ = tquant.quantize_array(w)
    x = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    y = dequant_matmul(x, torch.from_numpy(q), torch.from_numpy(scale))
    want = (x.double() @ torch.from_numpy(q).double().T) * \
        torch.from_numpy(scale).double()
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    # bf16 activations: q cast exactly, the product in float32
    yb = dequant_matmul(x.to(torch.bfloat16), torch.from_numpy(q),
                        torch.from_numpy(scale))
    assert yb.dtype == torch.float32


@pytest.mark.parametrize("which", ["mlp", "transformer"])
def test_quantized_predict_matches_jax(which, mlp_pair, tf_pair):
    jm, tm = mlp_pair if which == "mlp" else tf_pair
    x = _x() if which == "mlp" else _tokens()
    base = tm.predict(x)
    jrep = jm.quantize_weights("int8")
    trep = tm.quantize_weights("int8")
    assert trep == jrep
    got, want = tm.predict(x), np.asarray(jm.predict(x), np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # quantized against full precision: a bounded deviation, not equality
    assert not np.array_equal(got, base)
    np.testing.assert_allclose(got, base, atol=0.2)


@pytest.mark.parametrize("which", ["mlp", "transformer"])
def test_quantized_engine_equals_quantized_predict(which, mlp_pair,
                                                   tf_pair):
    jm, tm = mlp_pair if which == "mlp" else tf_pair
    x = _x() if which == "mlp" else _tokens()
    with ServingEngine(tm) as eng:
        assert eng.quantize == "int8"
        out = eng.submit(x).result(timeout=60)
        snap = eng.stats()
    assert snap["quantize"] == "int8"
    np.testing.assert_array_equal(out, tm.predict(x))
    # the JAX engine serves the same rows within the parity tolerance
    with JaxServingEngine(jm) as jeng:
        jout = jeng.submit(x).result(timeout=60)
    np.testing.assert_allclose(out, np.asarray(jout, np.float32),
                               rtol=RTOL, atol=ATOL)


def test_quantize_releases_the_float32_kernels():
    m = _mlp(ft)
    refs = {w.name: weakref.ref(m._params[w.name])
            for _, w in tquant.eligible_weights(m.layers)}
    bias = m._params["d1/bias"]
    m.predict(_x())                  # a cached forward exists
    rep = m.quantize_weights("int8")
    gc.collect()
    assert all(r() is None for r in refs.values())
    assert m._params["d1/bias"] is bias          # biases are kept as is
    assert m.quantize_weights("int8") is rep     # idempotent
    with pytest.raises(ValueError, match="already quantized"):
        m.quantize_weights("int4")
    assert m.predict(_x()).shape == (12, 3)


@pytest.mark.parametrize("verb", ["fit", "train_batch", "train_window",
                                  "evaluate", "save_checkpoint"])
def test_quantized_model_refuses_training_verbs(verb, tmp_path):
    m = _mlp(ft, quantize="int8")
    m.quantize_weights("int8")
    x, y = _x(), np.zeros((12, 1), np.int32)
    with pytest.raises(RuntimeError, match="quantized"):
        if verb == "fit":
            m.fit(x, y, epochs=1)
        elif verb == "train_batch":
            m.train_batch(x[:4], y[:4])
        elif verb == "train_window":
            m.train_window((x[None, :4], y[None, :4]))
        elif verb == "evaluate":
            m.evaluate(x, y)
        else:
            m.save_checkpoint(str(tmp_path / "q.npz"))
    assert not list(tmp_path.iterdir())


def test_engine_warmup_rejects_violated_bound():
    m = _mlp(ft, quantize="int8")
    m.quantize_weights("int8")
    # tamper the report: the warm-up check must trip before any bucket
    m._quant_report = dict(m._quant_report, bound_ok=False,
                           max_abs_err=1.0, error_bound=0.1)
    with pytest.raises(RuntimeError, match="quality bound"):
        ServingEngine(m)


def test_precision_policy_equals_jax():
    for kw, strategies in (({"compute_dtype": "bfloat16"}, {}),
                           ({"compute_dtype": "float32",
                             "serve_quantize": "int8"},
                            {"a": "bf16", "b": "f32"}),
                           ({"compute_dtype": "float16"}, {"a": "f32"})):
        jcfg, tcfg = ff.FFConfig(**kw), ft.FFConfig(**kw)
        for name, prec in strategies.items():
            jcfg.strategies[name] = JaxParallelConfig(precision=prec)
            tcfg.strategies[name] = ParallelConfig(precision=prec)
        assert tcfg.precision_policy() == jcfg.precision_policy()
    assert ft.FFConfig(compute_dtype="float32", serve_quantize="int8"
                       ).precision_policy() == "f32+int8w"
