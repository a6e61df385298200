"""The Transformer end to end: the port's FFModel against the JAX
package's, on the CPU.

Both packages build ``build_transformer`` (2 layers, d_model 64, 4 heads,
d_ff 128, s 32, vocab 128, 2 classes) and ``build_transformer_lm`` (the
causal LM, rank-3 logits with (n, s) labels) at batch 4 in float32.  The
JAX model's initial weights are carried into the port with
``interop.params_from_jax_numpy``; then ``predict`` must agree within
1e-5, three Adam steps of ``train_batch`` must give the same losses
(rtol 1e-5) and parameters (atol 1e-5), and ``evaluate`` and one epoch
of ``fit`` the same loss and metrics (Adam at the BERT example's alpha
1e-4; see ``ALPHA``).  On the CPU the port's attention
and LayerNorm run the plain versions of their kernels, and the JAX
package its dense attention (its flash kernel is TPU-only) and its stock
LayerNorm.  The shape and elementwise ops of the graph are held against
the JAX ops one by one, and the serving engine against ``predict``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models.transformer import build_transformer as jax_enc
from flexflow_tpu.models.transformer import build_transformer_lm as jax_lm
from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.elementwise import ElementBinary as JaxBinary
from flexflow_tpu.ops.tensor_ops import Dropout as JaxDropout
from flexflow_tpu.ops.tensor_ops import Reshape as JaxReshape
from flexflow_tpu.ops.tensor_ops import Split as JaxSplit
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.tensor import Tensor as JaxTensor
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.models import build_transformer, build_transformer_lm
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops.elementwise import _BINARY, ElementBinary
from flexflow_tpu_torch.ops.tensor_ops import Dropout, Reshape, Split
from flexflow_tpu_torch.serving import ServingEngine
from flexflow_tpu_torch.tensor import Tensor

BS, SEQ, VOCAB, CLASSES = 4, 32, 128, 2
ARCH = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, seq_len=SEQ)
METRICS = ["accuracy", "sparse_categorical_crossentropy"]
TOL = 1e-5
# examples/apps/transformer.py's Adam rate.  Adam moves every parameter
# by about alpha per step whatever its gradient's size, so a gradient
# element within summation noise of 0 can move ~alpha apart in the two
# frameworks: at 1e-3 one such element of wv strays 1.1e-5 in 3 steps
ALPHA = 1e-4


def _weights(m):
    return {p.name: np.asarray(m.get_weights(p.name), np.float32)
            for p in m.parameters}


def _build(pkg, kind, **kw):
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    if kind == "encoder":
        fn = jax_enc if pkg is ff else build_transformer
        m, _, logits = fn(cfg, vocab_size=VOCAB, num_classes=CLASSES, **ARCH,
                          **kw)
    else:
        fn = jax_lm if pkg is ff else build_transformer_lm
        m, _, logits = fn(cfg, vocab_size=VOCAB, **ARCH, **kw)
    extra = {"mesh": MachineMesh({"n": 1})} if pkg is ff else {}
    m.compile(pkg.AdamOptimizer(alpha=ALPHA),
              "sparse_categorical_crossentropy", METRICS,
              final_tensor=logits, **extra)
    m.init_layers(seed=0)
    return m


def _data(kind, seed=0):
    rng = np.random.default_rng(seed)
    label_shape = (BS, 1) if kind == "encoder" else (BS, SEQ)
    n_labels = CLASSES if kind == "encoder" else VOCAB
    steps = [(rng.integers(0, VOCAB, (BS, SEQ)).astype(np.int32),
              rng.integers(0, n_labels, label_shape).astype(np.int32))
             for _ in range(3)]
    n_eval = 10
    x_eval = rng.integers(0, VOCAB, (n_eval, SEQ)).astype(np.int32)
    y_eval = rng.integers(0, n_labels, (n_eval,) + label_shape[1:]).astype(
        np.int32)
    return steps, x_eval, y_eval


@pytest.fixture(scope="module", params=["encoder", "lm"])
def jax_run(request):
    kind = request.param
    m = _build(ff, kind)
    w0 = _weights(m)
    steps, x_eval, y_eval = _data(kind)
    pred = np.asarray(m.predict(x_eval, batch_size=BS))
    losses = [float(m.train_batch(x, y)) for x, y in steps]
    w3 = _weights(m)
    eval_loss, eval_pm = m.evaluate(x_eval, y_eval, batch_size=BS)
    m.fit(x_eval, y_eval, epochs=1, verbose=False)
    return {"kind": kind, "w0": w0, "pred": pred, "losses": losses,
            "w3": w3, "eval_loss": eval_loss, "eval_pm": eval_pm,
            "fit_losses": m.last_epoch_losses, "fit_pm": m.perf_metrics}


def _port(jax_run):
    m = _build(ft, jax_run["kind"], device="cpu")
    interop.params_from_jax_numpy(m, jax_run["w0"])
    return m


def test_weight_carry_covers_every_parameter(jax_run):
    m = _build(ft, jax_run["kind"], device="cpu")
    names = {p.name for p in m.parameters}
    assert names == set(jax_run["w0"])
    for p in m.parameters:
        assert tuple(p.shape) == jax_run["w0"][p.name].shape, p.name
    interop.params_from_jax_numpy(m, jax_run["w0"])
    for name, want in jax_run["w0"].items():
        np.testing.assert_array_equal(m.get_weights(name), want)
    # one name short: refused
    short = dict(jax_run["w0"])
    short.pop("attention_0/wq")
    with pytest.raises(ValueError, match="attention_0/wq"):
        interop.params_from_jax_numpy(m, short)


def test_predict_matches_jax(jax_run):
    m = _port(jax_run)
    _, x_eval, _ = _data(jax_run["kind"])
    got = m.predict(x_eval, batch_size=BS)
    assert got.shape == jax_run["pred"].shape
    np.testing.assert_allclose(got, jax_run["pred"], atol=TOL, rtol=0)


def test_train_evaluate_fit_match_jax(jax_run):
    m = _port(jax_run)
    steps, x_eval, y_eval = _data(jax_run["kind"])
    losses = [float(m.train_batch(x, y)) for x, y in steps]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=TOL)
    got = _weights(m)
    for name, want in jax_run["w3"].items():
        np.testing.assert_allclose(got[name], want, rtol=0, atol=TOL,
                                   err_msg=name)
    loss, pm = m.evaluate(x_eval, y_eval, batch_size=BS)
    want = jax_run["eval_pm"]
    np.testing.assert_allclose(loss, jax_run["eval_loss"], rtol=TOL)
    assert (pm.train_all, pm.train_correct) == (want.train_all,
                                                want.train_correct)
    np.testing.assert_allclose(pm.sparse_cce_loss, want.sparse_cce_loss,
                               rtol=TOL)
    m.fit(x_eval, y_eval, epochs=1, verbose=False)
    np.testing.assert_allclose(m.last_epoch_losses, jax_run["fit_losses"],
                               rtol=TOL)
    fit_pm = jax_run["fit_pm"]
    assert (m.perf_metrics.train_all, m.perf_metrics.train_correct) == (
        fit_pm.train_all, fit_pm.train_correct)


def test_serving_engine_answers_token_rows_equal_to_predict(jax_run):
    m = _port(jax_run)
    rng = np.random.default_rng(9)
    reqs = [rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32)
            for n in (1, 3, 4, 2)]
    with ServingEngine(m, max_batch=BS) as eng:
        futs = [eng.submit(r) for r in reqs]
        outs = [f.result(timeout=60) for f in futs]
    want = m.predict(np.concatenate(reqs), batch_size=BS)
    got = np.concatenate(outs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_dropout_graph_trains_and_is_identity_at_inference():
    """With dropout > 0 the builders add Dropout ops and the attention
    draws its probability mask from the step's seed: a step is
    repeatable, dropout changes the training loss, and inference is the
    model without dropout."""
    plain = _build(ft, "encoder", device="cpu")
    drop = _build(ft, "encoder", dropout=0.2, device="cpu")
    assert any(isinstance(op, Dropout) for op in drop.layers)
    interop.params_from_jax_numpy(drop, _weights(plain))
    steps, x_eval, _ = _data("encoder")
    batch = drop._device_batch(steps[0])
    once = float(drop._loss_and_grads(batch, 0)[0])
    assert once == float(drop._loss_and_grads(batch, 0)[0])
    assert once != float(drop._loss_and_grads(batch, 1)[0])
    assert once != float(plain._loss_and_grads(batch, 0)[0])
    np.testing.assert_array_equal(drop.predict(x_eval, batch_size=BS),
                                  plain.predict(x_eval, batch_size=BS))
    assert np.isfinite([float(drop.train_batch(*s)) for s in steps]).all()


def _jctx(training=False):
    return JaxOpContext(training=training, compute_dtype="float32")


def _pair_forward(jop, op, arrays, training=False):
    want = jop.forward({}, [jnp.asarray(a) for a in arrays], _jctx(training))
    got = op.forward({}, [torch.from_numpy(a) for a in arrays],
                     OpContext(compute_dtype="float32", training=training,
                               seed=0 if training else None))
    assert len(got) == len(want) == len(op.outputs)
    for g, w, t in zip(got, want, op.outputs):
        assert tuple(g.shape) == tuple(t.shape) == tuple(w.shape)
    return got, want


def test_split_matches_jax():
    shape = (2, 9, 4)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    for sizes, axis in (([1, 8], 1), ([3, 3, 3], 1), ([1, 3], 2)):
        got, want = _pair_forward(JaxSplit("s", JaxTensor(shape), sizes,
                                           axis),
                                  Split("s", Tensor(shape), sizes, axis),
                                  [x])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_reshape_matches_jax_and_keeps_the_runtime_batch():
    shape = (4, 1, 6)
    op = Reshape("r", Tensor(shape), (4, 6))
    x = np.arange(24, dtype=np.float32).reshape(shape)
    got, want = _pair_forward(JaxReshape("r", JaxTensor(shape), (4, 6)), op,
                              [x])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # a smaller runtime batch keeps its own leading dim
    (y,) = op.forward({}, [torch.from_numpy(x[:2])], OpContext())
    assert tuple(y.shape) == (2, 6)


@pytest.mark.parametrize("fn", sorted(_BINARY))
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("float32", "int32"),
                                    ("bfloat16", "float32")])
def test_element_binary_matches_jax(fn, dtypes):
    rng = np.random.default_rng(1)
    a = (rng.random((3, 5)) + 0.5).astype(np.float32)
    b = (rng.random((1, 5)) + 0.5).astype(np.float32)
    if dtypes[1] == "int32":
        b = rng.integers(1, 4, (1, 5)).astype(np.int32)
    ja, jb = jnp.asarray(a).astype(dtypes[0]), jnp.asarray(b)
    ta = torch.from_numpy(a).to(getattr(torch, dtypes[0]))
    tb = torch.from_numpy(b)
    (want,) = JaxBinary("e", JaxTensor(a.shape), JaxTensor(b.shape),
                        fn).forward({}, [ja, jb], _jctx())
    op = ElementBinary("e", Tensor(a.shape), Tensor(b.shape), fn)
    (got,) = op.forward({}, [ta, tb], OpContext())
    assert op.outputs[0].shape == (3, 5)
    assert str(got.dtype) == f"torch.{jnp.dtype(want.dtype).name}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=0)


def test_element_binary_refuses_an_unknown_function():
    with pytest.raises(ValueError, match="unknown binary op"):
        ElementBinary("e", Tensor((2,)), Tensor((2,)), "atan2")


def test_dropout_rate_zero_and_inference_are_identity_like_jax():
    x = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
    for rate, training in ((0.0, True), (0.5, False)):
        got, want = _pair_forward(JaxDropout("d", JaxTensor(x.shape), rate),
                                  Dropout("d", Tensor(x.shape), rate), [x],
                                  training)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[0].numpy(), x)


def test_dropout_keep_fraction_and_scaling():
    """torch's random bits are not JAX's: the two keep fractions agree
    statistically, and kept values are scaled by 1/keep in both."""
    rate = 0.3
    x = np.ones((256, 256), np.float32)
    jop = JaxDropout("d", JaxTensor(x.shape), rate)
    import jax
    (want,) = jop.forward({}, [jnp.asarray(x)],
                          JaxOpContext(training=True,
                                       rng=jax.random.PRNGKey(0),
                                       compute_dtype="float32"))
    op = Dropout("d", Tensor(x.shape), rate)
    (got,) = op.forward({}, [torch.from_numpy(x)],
                        OpContext(training=True, seed=0,
                                  compute_dtype="float32"))
    got, want = got.numpy(), np.asarray(want)
    for y in (got, want):
        kept = y != 0
        np.testing.assert_allclose(y[kept], 1.0 / (1.0 - rate), rtol=1e-6)
        # 65536 draws: the keep fraction is within 0.01 of 0.7
        assert abs(kept.mean() - (1.0 - rate)) < 0.01
    assert abs((got != 0).mean() - (want != 0).mean()) < 0.01
    # the same step and op give the same mask; another step another
    (again,) = op.forward({}, [torch.from_numpy(x)],
                          OpContext(training=True, seed=0))
    (other,) = op.forward({}, [torch.from_numpy(x)],
                          OpContext(training=True, seed=1))
    np.testing.assert_array_equal(again.numpy(), got)
    assert not np.array_equal(other.numpy(), got)
