"""The training-loop knobs of the port against the JAX package: gradient
accumulation, multi-step windows, padded tail batches and segmented
rematerialisation, case by case after ``tests/test_grad_accum.py``,
``tests/test_dispatch_window.py`` and ``tests/test_remat_memory.py``.

Both packages build the same graph in float32 (the JAX side on
``MachineMesh({"n": 1})``); the JAX model's initial weights are carried
into the port with ``interop.params_from_jax_numpy`` and the data comes
from numpy seeds.

Tolerances:
- the port against the JAX package, and an accumulated step against the
  full-batch step: losses within 1e-5 relative (1e-6 absolute) and
  parameters within 1e-5 relative (1e-6 absolute), the JAX tests' own
  bounds (the microbatch sums add in another order);
- the port against itself where the JAX tests pin bits (windows against
  single steps, remat against no remat with dropout on): bit-equal;
- remat's saved bytes: under a third of the plain step's, as the JAX
  test bounds its residuals.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.parallel.mesh import MachineMesh
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop, model as model_mod
from flexflow_tpu_torch.data.dataloader import PrefetchLoader
from flexflow_tpu_torch.ops import cuda_norm, cuda_pool

BS = 16
NFEAT = 12
NCLS = 5
RTOL = 1e-5
ATOL = 1e-6


def _cfg(pkg, batch=BS, accum=1, k=1, pad=False, remat=False):
    cfg = pkg.FFConfig(batch_size=batch, compute_dtype="float32")
    cfg.gradient_accumulation_steps = accum
    cfg.steps_per_dispatch = k
    cfg.pad_tail_batches = pad
    cfg.remat = remat
    return cfg


def _new(pkg, cfg):
    if pkg is ff:
        return ff.FFModel(cfg, mesh=MachineMesh({"n": 1}))
    return ft.FFModel(cfg, device="cpu")


def _mlp(pkg, **kw):
    m = _new(pkg, _cfg(pkg, **kw))
    x = m.create_tensor((kw.get("batch", BS), NFEAT), name="x")
    t = m.dense(x, 24, activation="relu")
    t = m.dense(t, NCLS)
    m.compile(pkg.SGDOptimizer(lr=0.1, momentum=0.9), metrics=["accuracy"])
    m.init_layers(seed=0)
    return m


def _sum_mse(pkg, **kw):
    """The sum-reduced family: op-form MSE with reduction='sum'."""
    m = _new(pkg, _cfg(pkg, **kw))
    x = m.create_tensor((BS, 6), name="x")
    t = m.dense(x, 8, activation="relu")
    t = m.dense(t, 1)
    p = m.mse_loss(t, reduction="sum")
    m.compile(pkg.SGDOptimizer(lr=0.01), metrics=[], final_tensor=p)
    m.init_layers(seed=0)
    return m


def _weights(m):
    return {p.name: np.asarray(m.get_weights(p.name), np.float32)
            for p in m.parameters}


def _twins(builder, **kw):
    """(port, jax) models with the JAX model's weights in both."""
    ref = builder(ff, **kw)
    port = builder(ft, **kw)
    interop.params_from_jax_numpy(port, _weights(ref))
    return port, ref


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, NFEAT)).astype(np.float32)
    y = rng.integers(0, NCLS, (n, 1)).astype(np.int32)
    return x, y


def _mse_data(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BS, 6)).astype(np.float32),
            rng.random((BS, 1)).astype(np.float32))


def _host_params(m):
    return {k: m.get_weights(k) for k in m._params}


def _close(got, want, what=""):
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {name}")


def _equal(got, want, what=""):
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], v, err_msg=f"{what} {name}")


# ----------------------------------------------------------------------
# gradient accumulation (tests/test_grad_accum.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_matches_full_batch(accum, reduction):
    """k equal microbatches, one update: the port's accumulated step
    equals its full-batch step and the JAX package's accumulated step,
    3 steps, for a mean-reduced (sparse CE) and a sum-reduced (MSE sum)
    loss."""
    builder, (x, y) = ((_mlp, _data(BS)) if reduction == "mean"
                       else (_sum_mse, _mse_data()))
    refk = builder(ff, accum=accum)
    port1, portk = builder(ft), builder(ft, accum=accum)
    for m in (port1, portk):
        interop.params_from_jax_numpy(m, _weights(refk))
    for _ in range(3):
        l1 = float(port1.train_batch(x, y))
        lk = float(portk.train_batch(x, y))
        lr = float(refk.train_batch(x, y))
        np.testing.assert_allclose(lk, l1, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(lk, lr, rtol=RTOL, atol=ATOL)
    _close(_host_params(portk), _host_params(port1), "accumulated vs full")
    _close(_host_params(portk), _weights(refk), "port vs jax")


def test_metric_sums_cover_full_batch():
    m = _mlp(ft, accum=4)
    x, y = _data(BS)
    m.train_batch(x, y)
    # accuracy sums count over the FULL batch, not one microbatch
    assert int(m._last_metric_sums["count"]) == 16


@pytest.mark.parametrize("entry", ["compile", "train_batch", "fit",
                                   "train_window"])
def test_indivisible_batch_rejected(entry):
    """Every entry point that feeds the step refuses a batch that does
    not divide into the microbatches (compile: batch_size 10 over 4)."""
    if entry == "compile":
        m = _new(ft, _cfg(ft, batch=10, accum=4))
        t = m.create_tensor((10, 4), name="x")
        m.dense(t, 2)
        with pytest.raises(ValueError, match="microbatch"):
            m.compile(ft.SGDOptimizer(lr=0.1))
        return
    m = _mlp(ft, accum=4)
    x, y = _data(BS)
    with pytest.raises(ValueError, match="microbatch"):
        if entry == "train_batch":
            m.train_batch(x[:10], y[:10])
        elif entry == "fit":
            m.fit(x, y, batch_size=6, epochs=1)
        else:
            m.train_window((x[:12].reshape(2, 6, NFEAT),
                            y[:12].reshape(2, 6, 1)))


@pytest.mark.parametrize("field", ["gradient_accumulation_steps",
                                   "steps_per_dispatch"])
def test_nonpositive_knobs_rejected(field):
    cfg = _cfg(ft)
    setattr(cfg, field, 0)
    m = _new(ft, cfg)
    t = m.create_tensor((BS, NFEAT), name="x")
    m.dense(t, 2)
    with pytest.raises(ValueError, match=f"{field} must be >= 1"):
        m.compile(ft.SGDOptimizer(lr=0.1))


def _emb(pkg, accum):
    m = _new(pkg, _cfg(pkg, batch=8, accum=accum))
    ids = m.create_tensor((8, 2), dtype="int32", name="ids")
    t = m.embedding(ids, 40, 8, aggr="sum", name="emb")
    t = m.dense(t, 1)
    p = m.mse_loss(t, reduction="average")
    m.compile(pkg.SGDOptimizer(lr=0.1), metrics=[], final_tensor=p)
    m.init_layers(seed=0)
    return m


def test_accum_disables_sparse_embedding_path():
    """Accumulation keeps the dense path for the table (per-microbatch
    row gathers cannot express one update), in both packages, and the
    port's steps match the JAX package's."""
    port, ref = _twins(_emb, accum=2)
    assert not port._sparse_specs and not ref._sparse_embedding_specs()
    assert _emb(ft, 1)._sparse_specs, "plain SGD without accumulation " \
                                      "keeps the sparse path"
    rng = np.random.default_rng(1)
    ids_v = rng.integers(0, 40, (8, 2)).astype(np.int32)
    y = rng.random((8, 1)).astype(np.float32)
    losses = [float(port.train_batch(ids_v, y)) for _ in range(3)]
    want = [float(ref.train_batch(ids_v, y)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
    _close(_host_params(port), _weights(ref))


def _moe_sum(pkg, accum):
    m = _new(pkg, _cfg(pkg, accum=accum))
    x = m.create_tensor((16, 4, 8), name="x")  # MoE wants (n, s, d)
    t = m.moe(x, num_experts=4, d_ff=16, k=1)
    t = m.reshape(t, (16, 32))
    t = m.dense(t, 1)
    p = m.mse_loss(t, reduction="sum")
    m.compile(pkg.SGDOptimizer(lr=0.0), metrics=[], final_tensor=p)
    m.init_layers(seed=0)
    return m


def test_sum_reduce_aux_losses_not_overcounted():
    """MoE's aux (load-balance) loss is batch-size-free: under
    sum-reduced accumulation it enters the objective once (scaled by
    1/k), not k times.  The port's accumulated loss equals the JAX
    package's, and lies within the per-microbatch routing variation of
    the full-batch loss (the JAX test's bound)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 4, 8)).astype(np.float32)
    y = rng.random((16, 1)).astype(np.float32)
    r1, r4 = _moe_sum(ff, 1), _moe_sum(ff, 4)
    p1, pk = _moe_sum(ft, 1), _moe_sum(ft, 4)
    for m in (r4, p1, pk):
        for name, v in _weights(r1).items():
            m.set_weights(name, v)
    l1 = float(p1.train_batch(x, y))
    lk = float(pk.train_batch(x, y))
    np.testing.assert_allclose(l1, float(r1.train_batch(x, y)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lk, float(r4.train_batch(x, y)),
                               rtol=RTOL, atol=ATOL)
    assert abs(lk - l1) < 0.25 * abs(l1), (l1, lk)


# ----------------------------------------------------------------------
# multi-step windows and padded tails (tests/test_dispatch_window.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
def test_window_parity_bitwise(accum):
    """fit() with K in {1, 4, 8}: per-step losses and final parameters
    bit-equal to K=1 (the one-batch loop), and K=1 within tolerance of
    the JAX package."""
    x, y = _data(8 * BS)
    ref = _mlp(ff, accum=accum)
    w0 = _weights(ref)
    ref.fit(x, y, epochs=2, verbose=False)
    base_losses = base_params = None
    for k in (1, 4, 8):
        m = _mlp(ft, k=k, accum=accum)
        interop.params_from_jax_numpy(m, w0)
        m.fit(x, y, epochs=2, verbose=False)
        losses = m.last_epoch_losses.copy()
        assert losses.shape == (8,)
        if k == 1:
            base_losses, base_params = losses, _host_params(m)
            np.testing.assert_allclose(losses, ref.last_epoch_losses,
                                       rtol=RTOL, atol=ATOL)
            _close(base_params, _weights(ref), "port vs jax")
            continue
        np.testing.assert_array_equal(losses, base_losses,
                                      err_msg=f"K={k} losses")
        _equal(_host_params(m), base_params, f"K={k}")


def test_window_tail_shorter_than_k():
    """10 batches under K=4 run as 4+4+2, bit-equal to K=1."""
    x, y = _data(10 * BS)
    m1, m4 = _mlp(ft), _mlp(ft, k=4)
    m1.fit(x, y, epochs=1, verbose=False)
    m4.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_array_equal(m4.last_epoch_losses,
                                  m1.last_epoch_losses)
    _equal(_host_params(m4), _host_params(m1))
    assert m1._step == m4._step == 10


def test_train_window_verb_matches_train_batch():
    """train_window == K sequential train_batch calls, bit for bit;
    the losses and metric sums come back stacked per step."""
    x, y = _data(4 * BS)
    m1, mw = _mlp(ft), _mlp(ft, k=4)
    losses1 = torch.stack([m1.train_batch(x[i * BS:(i + 1) * BS],
                                          y[i * BS:(i + 1) * BS])
                           for i in range(4)])
    window = tuple(a.reshape((4, BS) + a.shape[1:]) for a in (x, y))
    lossesw, sums = mw.train_window(window)
    np.testing.assert_array_equal(lossesw.numpy(), losses1.numpy())
    assert mw._step == 4
    assert tuple(sums["count"].shape) == (4,)
    _equal(_host_params(mw), _host_params(m1))


def test_loader_windows_match_batches():
    x, y = _data(7 * BS)
    m = _mlp(ft, k=3)
    loader = PrefetchLoader(m, [x], y, batch_size=BS, steps_per_dispatch=3)
    seq = list(PrefetchLoader(m, [x], y, batch_size=BS))
    windows = list(loader.iter_windows())
    assert [w[0][0].shape[0] for w in windows] == [3, 3, 1]
    assert all(nv is None for _, nv in windows)
    flat = [tuple(a[i] for a in w) for w, _ in windows
            for i in range(w[0].shape[0])]
    assert len(flat) == len(seq) == 7
    for got, want in zip(flat, seq):
        for g, wv in zip(got, want):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), wv.numpy())


def test_loader_pad_tail_nvalid_and_counters(capsys):
    n = 2 * BS + 5
    x, y = _data(n)
    m = _mlp(ft, k=2, pad=True)
    loader = PrefetchLoader(m, [x], y, batch_size=BS,
                            steps_per_dispatch=2, pad_tail=True)
    assert loader.num_steps == 3 and loader.tail_valid == 5
    assert loader.num_samples_used == n
    windows = list(loader.iter_windows())
    assert [w[0][0].shape[0] for w in windows] == [2, 1]
    np.testing.assert_array_equal(windows[0][1], [BS, BS])
    np.testing.assert_array_equal(windows[1][1], [5])
    tail_x = windows[1][0][0][0].numpy()
    assert np.all(tail_x[5:] == 0)  # padded rows are zeros
    np.testing.assert_array_equal(tail_x[:5], x[2 * BS:])
    capsys.readouterr()
    plain = PrefetchLoader(m, [x], y, batch_size=BS)
    # logged on the ff logger as the JAX loader logs it, not warned
    assert "[ff] info: dropping 5 tail samples" in capsys.readouterr().err
    assert plain.num_steps == 2 and plain.num_samples_used == 2 * BS


@pytest.mark.parametrize("k", [1, 4])
def test_pad_tail_trains_tail_samples(k):
    """The masked padded step == a plain step on just the valid rows
    (the mean over nvalid): held against ragged train_batch calls on the
    port and against the JAX package's padded fit."""
    n = 2 * BS + 6
    x, y = _data(n)
    jref = _mlp(ff, k=k, pad=True)
    w0 = _weights(jref)
    jref.fit(x, y, epochs=1, verbose=False)
    ref = _mlp(ft)
    interop.params_from_jax_numpy(ref, w0)
    for lo, hi in ((0, BS), (BS, 2 * BS), (2 * BS, n)):
        ref.train_batch(x[lo:hi], y[lo:hi])  # ragged final batch
    m = _mlp(ft, k=k, pad=True)
    interop.params_from_jax_numpy(m, w0)
    m.fit(x, y, epochs=1, verbose=False)
    assert m._step == 3
    assert m.last_epoch_losses.shape == (3,)
    _close(_host_params(m), _host_params(ref), "padded vs ragged")
    _close(_host_params(m), _weights(jref), "port vs jax")
    np.testing.assert_allclose(m.last_epoch_losses, jref.last_epoch_losses,
                               rtol=RTOL, atol=ATOL)
    # metric sums count only the VALID samples
    assert m.perf_metrics.train_all == n


def test_pad_tail_with_accum_parity():
    """Masked accumulation: per-microbatch masked sums carry the global
    denominator, so K and accumulation compose without drift (bit-equal
    across K) and match the JAX package."""
    n = BS + 8
    x, y = _data(n)
    runs = {}
    for k in (1, 2):
        m = _mlp(ft, k=k, accum=2, pad=True)
        m.fit(x, y, epochs=1, verbose=False)
        runs[k] = (m.last_epoch_losses.copy(), _host_params(m))
    np.testing.assert_array_equal(runs[1][0], runs[2][0])
    _equal(runs[2][1], runs[1][1])
    assert np.all(np.isfinite(runs[1][0]))
    jref = _mlp(ff, accum=2, pad=True)
    jm = _mlp(ft, accum=2, pad=True)
    interop.params_from_jax_numpy(jm, _weights(jref))
    jref.fit(x, y, epochs=1, verbose=False)
    jm.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(jm.last_epoch_losses, jref.last_epoch_losses,
                               rtol=RTOL, atol=ATOL)
    _close(_host_params(jm), _weights(jref), "port vs jax")


class _Clock:
    """``time.time`` that moves one second a call: fit's training time
    reads exactly 1 s, so its THROUGHPUT line prints the samples."""

    def __init__(self):
        self.t = 0.0

    def time(self):
        self.t += 1.0
        return self.t


def test_throughput_counts_actual_samples(capsys, monkeypatch):
    """The THROUGHPUT line counts what was trained: a padded-tail run
    counts the tail, a plain run does not."""
    n = BS + 4
    x, y = _data(n)
    for pad, want in ((True, n), (False, BS)):
        m = _mlp(ft, pad=pad)
        monkeypatch.setattr(model_mod, "time", _Clock())
        m.fit(x, y, epochs=1, verbose=True)
        out = capsys.readouterr().out
        assert f"THROUGHPUT = {want:.2f} samples/s" in out, out


# ----------------------------------------------------------------------
# segmented remat (tests/test_remat_memory.py)
# ----------------------------------------------------------------------
def _conv(pkg, remat, depth=12, batch=8, dropout=0.0, layout="nchw"):
    cfg = pkg.FFConfig(batch_size=batch, compute_dtype="float32",
                       remat=remat)
    if pkg is ft:
        cfg.conv_layout = layout
    m = _new(pkg, cfg)
    x = m.create_tensor((batch, 3, 16, 16), name="img")
    t = m.conv2d(x, 16, 3, 3, 1, 1, 1, 1, activation="relu")
    for i in range(depth):
        t = m.conv2d(t, 16, 3, 3, 1, 1, 1, 1, activation="relu")
        if dropout and i == 1:
            t = m.dropout(t, dropout)
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = m.batch_norm(t)
    t = m.flat(t)
    t = m.dense(t, 64, activation="relu")
    logits = m.dense(t, 10)
    m.compile(pkg.SGDOptimizer(lr=0.05),
              pkg.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, [],
              final_tensor=logits)
    m.init_layers(seed=0)
    return m


def _conv_data(batch=8):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((batch, 3, 16, 16), dtype=np.float32),
            rng.integers(0, 10, (batch, 1)).astype(np.int32))


def _saved_bytes(m, x, y) -> int:
    """Bytes that one training forward keeps for the backward: the
    distinct storages of the tensors autograd saves outside checkpointed
    segments (``saved_tensors_hooks``; a checkpointed segment's own
    hooks save nothing) and of the values the forward hands back (the
    segment boundaries under remat), less the parameters and inputs."""
    storages = {}

    def note(t):
        if isinstance(t, torch.Tensor) and t.numel():
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()

    skip = {v.untyped_storage().data_ptr() for v in m._params.values()}
    xb, yb = torch.from_numpy(x), torch.from_numpy(y)
    skip |= {xb.untyped_storage().data_ptr(),
             yb.untyped_storage().data_ptr()}

    def pack(t):
        note(t)
        return t

    trainable = {k: v.detach().requires_grad_(True)
                 for k, v in m._params.items() if k in m._trainable_names()}
    params = {**m._params, **trainable}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        values = m._forward_values(
            params, (xb,), training=True, seed=0, updates={},
            keep_uids=(m._loss_tensor.uid, m._final_tensor.uid))
        m._loss_fn(values[m._loss_tensor.uid], yb)
    for v in values.values():
        note(v)
    return sum(b for p, b in storages.items() if p not in skip)


def test_segmented_remat_shrinks_saved_residuals():
    x, y = _conv_data()
    a0 = _saved_bytes(_conv(ft, False), x, y)
    a1 = _saved_bytes(_conv(ft, True), x, y)
    # boundaries only: far below the full retained set for a deep chain
    assert a1 < a0 / 3, (a0, a1)


def test_remat_same_loss_and_running_stats():
    """Loss, parameters and BatchNorm's running statistics survive
    segmentation: the port's remat step equals its plain step, and the
    JAX package's remat step."""
    x, y = _conv_data()
    ref = _conv(ff, True)
    m0, m1 = _conv(ft, False), _conv(ft, True)
    for m in (m0, m1):
        interop.params_from_jax_numpy(m, _weights(ref))
    assert len(m1.remat_segments()) == 4  # 18 layers: isqrt 4
    l0 = float(m0.train_batch(x, y))
    l1 = float(m1.train_batch(x, y))
    lj = float(ref.train_batch(x, y))
    assert np.isfinite(l0) and l0 == l1, (l0, l1)
    np.testing.assert_allclose(l1, lj, rtol=RTOL, atol=ATOL)
    _equal(_host_params(m1), _host_params(m0), "remat vs plain")
    _close(_host_params(m1), _weights(ref), "port vs jax")
    mean = [p.name for p in m1.parameters if p.name.endswith("running_mean")]
    assert mean and float(np.abs(m1.get_weights(mean[0])).sum()) > 0.0


def test_dropout_mask_is_redrawn_the_same_under_remat():
    """A dropout inside a checkpointed segment: the recomputation draws
    its mask again from the op's generator, seeded afresh from the step
    seed (checkpoint does not restore a per-op generator), so the remat
    steps equal the plain steps of the same model from the same state,
    bit for bit, under accumulation too.  (A mask depends on its op's
    output uid, so the two runs share one model.)"""
    x, y = _conv_data()
    m = _conv(ft, False, dropout=0.5)
    seg0 = {op.name for op in m.remat_segments()[0]}
    assert "dropout" in seg0
    start = {k: v.clone() for k, v in m._params.items()}
    for accum in (1, 2):
        m.config.gradient_accumulation_steps = accum
        runs = []
        for remat in (False, True):
            m.config.remat = remat
            m._params = {k: v.clone() for k, v in start.items()}
            m._step = 0
            losses = [float(m.train_batch(x, y)) for _ in range(2)]
            runs.append((losses, _host_params(m)))
        assert runs[0][0] == runs[1][0], runs
        _equal(runs[1][1], runs[0][1], f"accum {accum}")
    # and the mask does depend on the step: two steps' masks differ
    m = _conv(ft, False, dropout=0.5)
    drop = [op for op in m.layers if op.name == "dropout"][0]
    ctxs = [ft.OpContext(seed=m._step_seed(s), training=True)
            for s in (0, 1)]
    ones = torch.ones(4, 16, 16, 16)
    a, b = (drop.forward({}, [ones], c)[0] for c in ctxs)
    assert not torch.equal(a, b)


def _spy(monkeypatch, module, name):
    """Count the calls of the kernel wrapper ``module.name`` (on a CUDA
    tensor each call is one launch; here each runs the plain version)."""
    calls = []
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def _reckoned(m, op_type, per_op=1) -> int:
    """Forward calls of the ops of ``op_type`` in one remat step: twice
    in a checkpointed segment (the forward, then the recomputation in
    the backward), once in the last segment."""
    segs = m.remat_segments()
    return sum(per_op * (1 if i == len(segs) - 1 else 2)
               * sum(op.op_type == op_type for op in seg)
               for i, seg in enumerate(segs))


def test_remat_forward_calls_follow_the_segments(monkeypatch):
    """The kernels' autograd functions run under recomputation: the
    max-pool and LayerNorm forward wrappers are called once more for
    every op in a checkpointed segment, the backward wrapper once per
    op (the reckoning chip_smoke.py holds the kernel launches to)."""
    pool = _spy(monkeypatch, cuda_pool, "max_pool_nhwc")
    pool_bwd = _spy(monkeypatch, cuda_pool, "max_pool_nhwc_backward")
    x, y = _conv_data()
    m = _conv(ft, True, layout="nhwc")
    m.train_batch(x, y)
    # the pool (layer 13 of 18) sits in the third of four segments
    assert len(pool) == _reckoned(m, ft.OpType.POOL2D) == 2
    assert len(pool_bwd) == 1
    pool.clear()
    m.config.remat = False
    m.train_batch(x, y)
    assert len(pool) == 1 and len(pool_bwd) == 2

    ln = _spy(monkeypatch, cuda_norm, "fused_layernorm")
    tcfg = ft.FFConfig(batch_size=2, compute_dtype="float32", remat=True)
    tm, _, logits = ft.build_transformer(
        tcfg, num_layers=3, d_model=16, num_heads=2, d_ff=32, seq_len=8,
        vocab_size=50, num_classes=2, device="cpu")
    tm.compile(ft.SGDOptimizer(lr=0.01), final_tensor=logits)
    tm.init_layers(seed=0)
    rng = np.random.default_rng(0)
    tm.train_batch(rng.integers(0, 50, (2, 8)).astype(np.int32),
                   rng.integers(0, 2, (2, 1)).astype(np.int32))
    want = _reckoned(tm, ft.OpType.LAYERNORM)
    assert want > 6 and len(ln) == want, (len(ln), want)
