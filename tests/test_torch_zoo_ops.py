"""The sequence and recommendation zoo's ops against the JAX package's, on
the CPU, in float32 unless stated.

The same seeded numpy inputs go through each JAX op and its counterpart
in ``flexflow_tpu_torch``:

- ``LSTM``: the three outputs within 1e-6 and the gradients with respect
  to x, wx, wh, the bias and (h0, c0) within 1e-5 (autograd through the
  port's loop against ``jax.vjp`` of the scan), with and without an
  initial state, at forget bias 1.0 and 0.0; in bfloat16, where both
  cast the carry h to bf16 before the recurrent product and multiply in
  float32, the outputs within one bf16 rounding.
- ``Embedding``'s ids: an id in ``[-rows, 0)`` wraps, an id outside
  ``[-rows, rows)`` reads a NaN row and gives the table no gradient, as
  ``jnp.take`` does, for ``aggr`` none, sum and avg: forward and table
  gradient within 1e-6, NaN where JAX has NaN.
- ``MSELoss`` is the identity, ``FFModel.mse_loss`` sets the loss and
  the mse metric as the JAX builder does; the losses (average and sum
  reductions) and the metric sums within 1e-6.
- The sparse embedding update (``FFConfig.sparse_embedding_updates``):
  eligibility as in JAX; sparse against dense inside the port and the
  port's sparse path against JAX's, over 4 SGD steps on duplicate ids,
  losses within 1e-6 relative and parameters within 1e-6 (the two paths
  add the same terms in another order); rows no id touched keep their
  bits; wrapped and out-of-range ids as the dense path treats them; and
  the imperative ``backward``/``update`` loop stays dense.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu import losses as jax_losses
from flexflow_tpu import metrics as jax_metrics
from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.linear import Embedding as JaxEmbedding
from flexflow_tpu.ops.rnn import LSTM as JaxLSTM
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.tensor import Tensor as JaxTensor
from flexflow_tpu_torch import interop, losses, metrics
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops.linear import Embedding
from flexflow_tpu_torch.ops.loss_ops import MSELoss
from flexflow_tpu_torch.ops.rnn import LSTM
from flexflow_tpu_torch.tensor import Tensor

F32_TOL = 1e-6
GRAD_TOL = 1e-5
BF16_ROUNDING = 2.0 ** -8
N, S, D, H = 3, 5, 6, 4


def _lstm_pair(with_state, forget_bias):
    def build(tensor_cls, op_cls):
        x = tensor_cls((N, S, D), "float32")
        state = ((tensor_cls((N, H), "float32"),
                  tensor_cls((N, H), "float32")) if with_state else None)
        return op_cls("lstm", x, H, initial_state=state,
                      forget_bias=forget_bias)

    jop, op = build(JaxTensor, JaxLSTM), build(Tensor, LSTM)
    assert [(w.name, w.shape) for w in op.weights] == \
        [(w.name, w.shape) for w in jop.weights]
    assert [t.shape for t in op.outputs] == [t.shape for t in jop.outputs]
    return jop, op


def _lstm_data(op, with_state, seed):
    rng = np.random.default_rng(seed)
    params = {w.name: (0.5 * rng.standard_normal(w.shape)).astype(np.float32)
              for w in op.weights}
    inputs = [rng.standard_normal((N, S, D)).astype(np.float32)]
    if with_state:
        inputs += [(0.5 * rng.standard_normal((N, H))).astype(np.float32)
                   for _ in range(2)]
    cots = [rng.standard_normal(t.shape).astype(np.float32)
            for t in op.outputs]
    return params, inputs, cots


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_forward_and_gradients_match_jax(with_state, forget_bias):
    jop, op = _lstm_pair(with_state, forget_bias)
    params, inputs, cots = _lstm_data(op, with_state, seed=3)
    names = list(params)

    def jfwd(p, xs):
        ctx = JaxOpContext(training=True, compute_dtype="float32")
        return jop.forward(p, xs, ctx)

    want, vjp = jax.vjp(jfwd, {k: jnp.asarray(v) for k, v in params.items()},
                        [jnp.asarray(x) for x in inputs])
    want_dp, want_dx = vjp([jnp.asarray(c) for c in cots])

    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    got = op.forward(tp, tx, OpContext(training=True,
                                       compute_dtype="float32"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=F32_TOL)
    grads = torch.autograd.grad(got, [tp[k] for k in names] + tx,
                                [torch.from_numpy(c) for c in cots])
    for k, g in zip(names, grads[:len(names)]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_dp[k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    for g, w in zip(grads[len(names):], want_dx):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_lstm_bf16_forward_matches_jax():
    jop, op = _lstm_pair(True, 1.0)
    params, inputs, _ = _lstm_data(op, True, seed=4)
    want = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                       [jnp.asarray(x) for x in inputs],
                       JaxOpContext(training=False, compute_dtype="bfloat16"))
    got = op.forward({k: torch.from_numpy(v) for k, v in params.items()},
                     [torch.from_numpy(x) for x in inputs],
                     OpContext(compute_dtype="bfloat16"))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=BF16_ROUNDING * np.abs(w).max())


ROWS = 7


@pytest.mark.parametrize("aggr", ["none", "sum", "avg"])
def test_embedding_reads_ids_as_jnp_take(aggr):
    """Wrapped ids (-1, -rows) read their row and train it; ids -rows-1,
    rows and rows+7 read NaN and give the table nothing."""
    ids = np.array([[0, -1, 3], [-ROWS, 6, 2], [-ROWS - 1, 1, 1],
                    [ROWS, 4, 5], [ROWS + 7, 0, -2]], np.int32)
    jop = JaxEmbedding("emb", JaxTensor(ids.shape, "int32"), ROWS, 4, aggr)
    op = Embedding("emb", Tensor(ids.shape, "int32"), ROWS, 4, aggr)
    rng = np.random.default_rng(5)
    table = rng.standard_normal((ROWS, 4)).astype(np.float32)
    cot = rng.standard_normal(op.outputs[0].shape).astype(np.float32)
    name = op.w_table.name

    def jfwd(t):
        return jop.forward({name: t}, [jnp.asarray(ids)],
                           JaxOpContext(compute_dtype="float32"))[0]

    want, vjp = jax.vjp(jfwd, jnp.asarray(table))
    (want_dt,) = vjp(jnp.asarray(cot))
    tt = torch.from_numpy(table).requires_grad_(True)
    (got,) = op.forward({name: tt}, [torch.from_numpy(ids)],
                        OpContext(compute_dtype="float32"))
    (got_dt,) = torch.autograd.grad(got, tt, torch.from_numpy(cot))
    want = np.asarray(want)
    assert np.isnan(want).any() and not np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()),
                                  np.isnan(want))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(got_dt.numpy(), np.asarray(want_dt), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("reduction", ["average", "sum"])
def test_mse_loss_op_loss_and_metric_match_jax(reduction):
    def build(pkg, **kw):
        m = pkg.FFModel(pkg.FFConfig(batch_size=4, compute_dtype="float32"),
                        **kw)
        x = m.create_tensor((4, 3), name="x")
        p = m.mse_loss(m.dense(x, 2), reduction=reduction)
        return m, p

    jm, jp = build(ff)
    m, p = build(ft, device="cpu")
    assert isinstance(m.layers[-1], MSELoss) and p.shape == jp.shape
    assert m.loss_type == jm.loss_type and m.metrics == jm.metrics == [
        "mean_squared_error"]
    assert m.layers[-1].name == "mse_loss"
    m.compile(ft.SGDOptimizer(lr=0.1), metrics=[], final_tensor=p)
    assert m.metrics == ["mean_squared_error"]
    assert m.label_tensor.shape == (4, 2) and m.label_tensor.dtype == \
        "float32"
    (y,) = m.layers[-1].forward({}, [torch.ones(4, 2)], OpContext())
    assert torch.equal(y, torch.ones(4, 2))

    rng = np.random.default_rng(6)
    preds = rng.standard_normal((4, 2)).astype(np.float32)
    labels = rng.standard_normal((4, 2)).astype(np.float32)
    want = jax_losses.get_loss_fn(jm.loss_type)(jnp.asarray(preds),
                                                jnp.asarray(labels))
    got = losses.get_loss_fn(m.loss_type)(torch.from_numpy(preds),
                                          torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=F32_TOL)
    want_sums = jax_metrics.compute_batch_metrics(
        jnp.asarray(preds), jnp.asarray(labels), jm.metrics, jm.loss_type)
    got_sums = metrics.compute_batch_metrics(
        torch.from_numpy(preds), torch.from_numpy(labels), m.metrics,
        m.loss_type)
    assert set(got_sums) == set(want_sums)
    for k in want_sums:
        np.testing.assert_allclose(float(got_sums[k]), float(want_sums[k]),
                                   rtol=F32_TOL, err_msg=k)


EMB = (50, 30)
BS, BAG = 8, 3


def _sparse_model(pkg, sparse, optimizer=None, aggr="sum"):
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    cfg.sparse_embedding_updates = sparse
    m = (pkg.FFModel(cfg, mesh=MachineMesh({"n": 1})) if pkg is ff
         else pkg.FFModel(cfg, device="cpu"))
    ids0 = m.create_tensor((BS, BAG), dtype="int32", name="ids0")
    ids1 = m.create_tensor((BS, 1), dtype="int32", name="ids1")
    e0 = m.embedding(ids0, EMB[0], 8, aggr=aggr, name="emb0")
    e1 = m.embedding(ids1, EMB[1], 8, aggr="sum", name="emb1")
    t = m.concat([e0, e1], axis=1)
    t = m.dense(t, 4, activation="relu")
    t = m.dense(t, 1)
    p = m.mse_loss(t, reduction="average")
    m.compile(optimizer or pkg.SGDOptimizer(lr=0.1), metrics=[],
              final_tensor=p)
    m.init_layers(seed=0)
    return m


def _sparse_data(bad_ids=False):
    rng = np.random.default_rng(1)
    ids0 = rng.integers(0, EMB[0], (BS, BAG)).astype(np.int32)
    ids0[0, 0] = ids0[0, 1] = ids0[1, 0]      # duplicates in and across bags
    ids1 = rng.integers(0, EMB[1], (BS, 1)).astype(np.int32)
    if bad_ids:
        ids0[0, 0] = EMB[0] + 7               # NaN row, gradient dropped
        ids0[3, 2] = -EMB[0] - 1              # the same
        ids1[1, 0] = -1                       # wraps to the last row
    y = rng.random((BS, 1)).astype(np.float32)
    return [ids0, ids1], y


def _weights(m):
    return {p.name: np.asarray(m.get_weights(p.name), np.float32)
            for p in m.parameters}


def _run_sparse(pkg, sparse, w0=None, steps=4, bad_ids=False, **kw):
    m = _sparse_model(pkg, sparse, **kw)
    if w0 is not None:
        interop.params_from_jax_numpy(m, w0)
    xs, y = _sparse_data(bad_ids)
    losses_ = [float(m.train_batch(*xs, y)) for _ in range(steps)]
    return m, losses_


def _assert_same_params(a, b, tol=F32_TOL):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.isnan(a[k]), np.isnan(b[k]),
                                      err_msg=k)
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol, err_msg=k)


def test_sparse_eligibility_matches_jax():
    cases = [
        (None, lambda pkg: pkg.SGDOptimizer(lr=0.1), 2),
        (True, lambda pkg: pkg.SGDOptimizer(lr=0.1), 2),
        (False, lambda pkg: pkg.SGDOptimizer(lr=0.1), 0),
        (None, lambda pkg: pkg.SGDOptimizer(lr=0.1, momentum=0.9), 0),
        (None, lambda pkg: pkg.SGDOptimizer(lr=0.1, weight_decay=1e-4), 0),
        (None, lambda pkg: pkg.AdamOptimizer(alpha=1e-3), 0),
    ]
    for sparse, opt, n_tables in cases:
        jm = _sparse_model(ff, sparse, optimizer=opt(ff))
        m = _sparse_model(ft, sparse, optimizer=opt(ft))
        assert m._sparse_embedding_specs() == \
            jm._sparse_embedding_specs() == m._sparse_specs
        assert len(m._sparse_specs) == n_tables, (sparse, opt(ft))


@pytest.mark.parametrize("aggr", ["sum", "avg"])
def test_sparse_matches_dense_and_jax(aggr):
    jm, jl = _run_sparse(ff, None, aggr=aggr)
    w0 = _weights(_sparse_model(ff, None, aggr=aggr))
    ms, ls = _run_sparse(ft, None, w0, aggr=aggr)
    md, ld = _run_sparse(ft, False, w0, aggr=aggr)
    assert len(ms._sparse_specs) == 2 and not md._sparse_specs
    np.testing.assert_allclose(ls, ld, rtol=F32_TOL)
    np.testing.assert_allclose(ls, jl, rtol=F32_TOL)
    _assert_same_params(_weights(ms), _weights(md))
    _assert_same_params(_weights(ms), _weights(jm))
    # the step leaves the tables out of the optimizer's dict
    xs, y = _sparse_data()
    batch = ms._device_batch(xs + [y])
    _, _, grads, _, row_grads = ms._loss_and_grads(batch, 0, sparse=True)
    assert not {"emb0/table", "emb1/table"} & set(grads)
    assert row_grads["emb0"].shape == ((BS, BAG, 8))
    assert row_grads["emb1"].shape == (BS, 1, 8)


def test_sparse_leaves_untouched_rows_bit_equal():
    w0 = _weights(_sparse_model(ff, None))
    m, _ = _run_sparse(ft, None, w0, steps=2)
    xs, _ = _sparse_data()
    for i, name in enumerate(("emb0/table", "emb1/table")):
        touched = set(xs[i].ravel().tolist())
        untouched = [r for r in range(EMB[i]) if r not in touched]
        got = m.get_weights(name)
        np.testing.assert_array_equal(got[untouched], w0[name][untouched])
        assert not np.array_equal(got[sorted(touched)],
                                  w0[name][sorted(touched)])


def test_sparse_wrapped_and_out_of_range_ids_match_dense_and_jax():
    """Held against JAX's dense path, which defines the semantics: JAX's
    sparse scatter wraps an id below -rows once (-rows-1 lands on the
    last row), where its dense gradient drops it."""
    jm, jl = _run_sparse(ff, False, steps=2, bad_ids=True)
    w0 = _weights(_sparse_model(ff, None))
    ms, ls = _run_sparse(ft, None, w0, steps=2, bad_ids=True)
    md, ld = _run_sparse(ft, False, w0, steps=2, bad_ids=True)
    np.testing.assert_allclose(ls, ld, rtol=F32_TOL)
    np.testing.assert_allclose(ls, jl, rtol=F32_TOL)
    assert np.isnan(ls).all()
    ws, wd, wj = _weights(ms), _weights(md), _weights(jm)
    _assert_same_params(ws, wd)
    _assert_same_params(ws, wj)
    # the wrapped -1 trained emb1's last row; no NaN reached emb1, whose
    # ids are all in range (the ReLUs give a NaN input no gradient)
    last = ws["emb1/table"][EMB[1] - 1]
    assert np.isfinite(ws["emb1/table"]).all()
    assert not np.array_equal(last, w0["emb1/table"][EMB[1] - 1])


def test_imperative_loop_stays_dense():
    m = _sparse_model(ft, None)
    assert m._sparse_specs
    xs, y = _sparse_data()
    m.set_batch(*xs, y)
    m.zero_gradients()
    m.backward()
    assert {"emb0/table", "emb1/table"} <= set(m._cached_grads)
    assert m._cached_grads["emb0/table"].shape == (EMB[0], 8)
    before = m.get_weights("emb0/table")
    m.update()
    assert not np.array_equal(m.get_weights("emb0/table"), before)
