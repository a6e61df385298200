"""DLRM, CANDLE-Uno, NMT and the LSTM language model end to end: the
port's FFModel against the JAX package's, on the CPU, in float32.

Both packages build each model at a small size (DLRM: tables 100, 200
and 300 rows of 8, ``mlp_bot`` (4, 16, 8), ``mlp_top`` (32, 16, 1);
CANDLE-Uno: features 12, 20 and 16 wide with towers (8, 8) and a
(16, 8) trunk; NMT: vocab 50, width 16, 2 + 2 layers, src 5, tgt 6; the
LSTM LM: vocab 40, width 12, 2 layers, s 7).  The JAX model's initial
weights are carried into the port with ``interop.params_from_jax_numpy``;
then ``predict`` must agree within 1e-5, the dense gradients of one
``backward()`` within 1e-5, three plain-SGD ``train_batch`` steps the
same losses (rtol 1e-5) and parameters (atol 1e-5), with the embedding
tables on the sparse update path in both packages, and ``evaluate`` the
same loss and metrics.  ``ServingEngine`` takes DLRM's mixed int32 and
float32 inputs and returns NMT's per-token probabilities as ``predict``
does.
"""

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models.candle_uno import build_candle_uno as jax_uno
from flexflow_tpu.models.dlrm import build_dlrm as jax_dlrm
from flexflow_tpu.models.nmt import build_lstm_lm as jax_lm
from flexflow_tpu.models.nmt import build_nmt as jax_nmt
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.models import (build_candle_uno, build_dlrm,
                                       build_lstm_lm, build_nmt)
from flexflow_tpu_torch.serving import ServingEngine

TOL = 1e-5
BS = 4
N_EVAL = 6
LR = 0.1

DLRM = dict(embedding_size=(100, 200, 300), sparse_feature_size=8,
            mlp_bot=(4, 16, 8), mlp_top=(32, 16, 1))
UNO_FEATURES = {"dose": 1, "cell.rnaseq": 12, "drug.descriptors": 20,
                "drug.fingerprints": 16}
UNO = dict(dense_layers=(16, 8), dense_feature_layers=(8, 8),
           feature_shapes=UNO_FEATURES)
NMT = dict(vocab_size=50, embed_dim=16, hidden_dim=16, num_layers=2,
           src_len=5, tgt_len=6)
LM = dict(vocab_size=40, embed_dim=12, hidden_dim=12, num_layers=2,
          seq_len=7)
BUILDERS = {"dlrm": (jax_dlrm, build_dlrm, DLRM),
            "candle_uno": (jax_uno, build_candle_uno, UNO),
            "nmt": (jax_nmt, build_nmt, NMT),
            "lstm_lm": (jax_lm, build_lstm_lm, LM)}
SEQ_METRICS = ["accuracy", "sparse_categorical_crossentropy"]


def _build(pkg, kind, **kw):
    jax_fn, port_fn, arch = BUILDERS[kind]
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    fn = jax_fn if pkg is ff else port_fn
    m, _, out = fn(cfg, **arch, **kw)
    extra = {"mesh": MachineMesh({"n": 1})} if pkg is ff else {}
    if kind in ("dlrm", "candle_uno"):
        # the op-form MSE loss set the loss type and the mse metric
        m.compile(pkg.SGDOptimizer(lr=LR), metrics=[], final_tensor=out,
                  **extra)
    else:
        m.compile(pkg.SGDOptimizer(lr=LR),
                  "sparse_categorical_crossentropy", SEQ_METRICS, **extra)
    m.init_layers(seed=0)
    return m


def _inputs(kind, n, rng):
    if kind == "dlrm":
        xs = [rng.integers(0, v, (n, 1)).astype(np.int32)
              for v in DLRM["embedding_size"]]
        xs.append(rng.standard_normal((n, DLRM["mlp_bot"][0])).astype(
            np.float32))
        return xs, rng.random((n, 1)).astype(np.float32)
    if kind == "candle_uno":
        widths = [1, 1, 12, 20, 16]
        xs = [rng.standard_normal((n, w)).astype(np.float32) for w in widths]
        return xs, rng.random((n, 1)).astype(np.float32)
    if kind == "nmt":
        src = rng.integers(0, NMT["vocab_size"], (n, NMT["src_len"]))
        tgt = rng.integers(0, NMT["vocab_size"], (n, NMT["tgt_len"]))
        y = np.roll(tgt, -1, axis=1)
        return [src.astype(np.int32), tgt.astype(np.int32)], y.astype(
            np.int32)
    tok = rng.integers(0, LM["vocab_size"], (n, LM["seq_len"]))
    return [tok.astype(np.int32)], np.roll(tok, -1, axis=1).astype(np.int32)


def _data(kind):
    rng = np.random.default_rng(7)
    steps = [_inputs(kind, BS, rng) for _ in range(3)]
    return steps, _inputs(kind, N_EVAL, rng)


def _weights(m):
    return {p.name: np.asarray(m.get_weights(p.name), np.float32)
            for p in m.parameters}


@pytest.fixture(scope="module", params=list(BUILDERS))
def jax_run(request):
    kind = request.param
    m = _build(ff, kind)
    w0 = _weights(m)
    steps, (x_eval, y_eval) = _data(kind)
    pred = np.asarray(m.predict(x_eval, batch_size=BS), np.float32)
    m.set_batch(*steps[0][0], steps[0][1])
    m.zero_gradients()
    loss0 = float(m.backward())
    grads = {k: np.asarray(v, np.float32)
             for k, v in m._cached_grads.items()}
    m.zero_gradients()
    losses = [float(m.train_batch(*x, y)) for x, y in steps]
    eval_loss, eval_pm = m.evaluate(x_eval, y_eval, batch_size=BS)
    return {"kind": kind, "w0": w0, "pred": pred, "loss0": loss0,
            "grads": grads, "losses": losses, "w3": _weights(m),
            "sparse": len(m._sparse_embedding_specs()),
            "eval_loss": eval_loss, "eval_pm": eval_pm.scalars()}


def _port(jax_run):
    m = _build(ft, jax_run["kind"], device="cpu")
    interop.params_from_jax_numpy(m, jax_run["w0"])
    return m


def test_builds_the_same_graph(jax_run):
    m = _build(ft, jax_run["kind"], device="cpu")
    assert {p.name: tuple(p.shape) for p in m.parameters} == {
        k: v.shape for k, v in jax_run["w0"].items()}
    assert m.num_parameters == sum(v.size for v in jax_run["w0"].values())
    assert len(m._sparse_specs) == jax_run["sparse"]
    # compile's labels: (n, 1) float32 targets for the MSE heads, (n, s)
    # int32 next-token ids for the sequence models
    label = m.label_tensor
    if jax_run["kind"] in ("dlrm", "candle_uno"):
        assert (label.shape, label.dtype) == ((BS, 1), "float32")
    else:
        assert label.shape == (BS, m.input_tensors[-1].shape[1])
        assert label.dtype == "int32"
    # every embedding of the zoo takes its ids from a graph input
    assert jax_run["sparse"] == {"dlrm": 3, "candle_uno": 0, "nmt": 2,
                                 "lstm_lm": 1}[jax_run["kind"]]


def test_predict_and_gradients_match_jax(jax_run):
    m = _port(jax_run)
    steps, (x_eval, _) = _data(jax_run["kind"])
    got = m.predict(x_eval, batch_size=BS)
    assert got.shape == jax_run["pred"].shape
    np.testing.assert_allclose(got, jax_run["pred"], atol=TOL, rtol=0)
    m.set_batch(*steps[0][0], steps[0][1])
    m.zero_gradients()
    np.testing.assert_allclose(float(m.backward()), jax_run["loss0"],
                               rtol=TOL)
    assert set(m._cached_grads) == set(jax_run["grads"])
    for k, want in jax_run["grads"].items():
        np.testing.assert_allclose(m._cached_grads[k].numpy(), want,
                                   atol=TOL, rtol=0, err_msg=k)


def test_sgd_steps_and_evaluate_match_jax(jax_run):
    m = _port(jax_run)
    steps, (x_eval, y_eval) = _data(jax_run["kind"])
    losses = [float(m.train_batch(*x, y)) for x, y in steps]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=TOL)
    w3 = _weights(m)
    for k, want in jax_run["w3"].items():
        np.testing.assert_allclose(w3[k], want, atol=TOL, rtol=0, err_msg=k)
    eval_loss, pm = m.evaluate(x_eval, y_eval, batch_size=BS)
    np.testing.assert_allclose(eval_loss, jax_run["eval_loss"], rtol=TOL)
    got = pm.scalars()
    for k, want in jax_run["eval_pm"].items():
        np.testing.assert_allclose(got[k], want, rtol=TOL, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["dlrm", "nmt"])
def test_serving_engine_matches_predict(kind):
    m = _build(ft, kind, device="cpu")
    rng = np.random.default_rng(8)
    reqs = [_inputs(kind, n, rng)[0] for n in (1, 3, BS, 2)]
    with ServingEngine(m, max_batch=BS) as eng:
        futs = [eng.submit(*r) for r in reqs]
        outs = [f.result(timeout=60) for f in futs]
    want = m.predict([np.concatenate(c) for c in zip(*reqs)], batch_size=BS)
    got = np.concatenate(outs)
    assert got.shape == want.shape
    if kind == "nmt":
        assert got.shape == (10, NMT["tgt_len"], NMT["vocab_size"])
        np.testing.assert_allclose(got.sum(axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_dlrm_default_top_mlp_is_refused_as_in_jax():
    """The builders' defaults put mlp_top[0] at 576, not the 320 of four
    64-wide tables beside a 64-wide bottom MLP: both refuse them."""
    small = dict(embedding_size=(10,) * 4, sparse_feature_size=64)
    cfg = ft.FFConfig(batch_size=2)
    with pytest.raises(ValueError, match="576"):
        build_dlrm(cfg, **small, device="cpu")
    with pytest.raises(AssertionError):
        jax_dlrm(ff.FFConfig(batch_size=2), **small)
    m, _, _ = build_dlrm(cfg, **small, mlp_top=(320, 512, 256, 1),
                         device="cpu")
    assert m.layers[-1].op_type == ft.OpType.MSELOSS
