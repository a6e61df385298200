"""The port's ServingEngine and micro-batcher against the JAX package's.

A small dense model (dense-relu-dense-softmax) is built in both packages
with the JAX weights carried across.  The port's engine, fed mixed
requests from several threads (one larger than ``max_batch``, so it is
split), must return rows bit-equal to the port's own ``predict`` and
within 1e-5 of the JAX engine.  Deadlines, ``reject`` admission and the
stats reconciliation run on an engine that is not started yet or on a
fake clock; the batcher's pure helpers and a scripted admission
sequence are held against their JAX counterparts.
"""

import threading

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.profiling import quantiles as jax_quantiles
from flexflow_tpu.serving import ServingEngine as JaxServingEngine
from flexflow_tpu.serving import batcher as jbatcher
from flexflow_tpu.serving import errors as jerrors
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.serving import (DeadlineExceeded, OverloadError,
                                        ServingEngine, SheddedError)
from flexflow_tpu_torch.serving import batcher as tbatcher
from flexflow_tpu_torch.serving import errors as terrors
from flexflow_tpu_torch.serving.metrics import quantiles

BS = 16
NFEAT = 12
NCLS = 5


def _build(pkg):
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32")
    if pkg is ff:
        m = ff.FFModel(cfg, mesh=MachineMesh({"n": 1}))
    else:
        m = ft.FFModel(cfg, device="cpu")
    x = m.create_tensor((BS, NFEAT), name="x")
    t = m.dense(x, 24, activation="relu")
    t = m.dense(t, NCLS)
    m.softmax(t)
    if pkg is ff:
        m.compile(ff.SGDOptimizer(lr=0.1))
    else:
        m.compile()
    m.init_layers(seed=0)
    return m


@pytest.fixture(scope="module")
def models():
    jm = _build(ff)
    tm = _build(ft)
    interop.params_from_jax_numpy(
        tm, {p.name: jm.get_weights(p.name) for p in jm.parameters})
    return jm, tm


def _requests(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s, NFEAT)).astype(np.float32)
            for s in sizes]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _serve(engine, per_thread):
    outs = [[None] * len(reqs) for reqs in per_thread]

    def producer(t):
        futs = [engine.submit(r) for r in per_thread[t]]
        for i, f in enumerate(futs):
            outs[t][i] = f.result(timeout=60)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(len(per_thread))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    return outs


def test_engine_threads_match_predict_and_jax_engine(models):
    jm, tm = models
    per_thread = [_requests([1, 3, 17, 40], seed=1),
                  _requests([3, 1, 17, 5], seed=2),
                  _requests([17, 2, 1, 8], seed=3)]
    with ServingEngine(tm, max_batch=BS) as eng:
        outs = _serve(eng, per_thread)
        snap = eng.stats()
    with JaxServingEngine(jm, max_batch=BS, stats_every=0) as jeng:
        jouts = _serve(jeng, per_thread)
    for reqs, got, jgot in zip(per_thread, outs, jouts):
        for r, y, jy in zip(reqs, got, jgot):
            assert y.shape == (r.shape[0], NCLS) and y.dtype == np.float32
            # bit-equal to the port's own predict for the same rows
            np.testing.assert_array_equal(y, tm.predict(r, batch_size=BS))
            np.testing.assert_allclose(y, np.asarray(jy, np.float32),
                                       rtol=0, atol=1e-5)
    n_req = sum(len(r) for r in per_thread)
    assert snap["requests"] == snap["submitted"] == n_req
    assert snap["rows"] == sum(r.shape[0] for rs in per_thread for r in rs)
    assert snap["health"] == "serving" and snap["errors"] == 0


def test_deadline_expires_before_packing(models):
    _, tm = models
    clk = FakeClock()
    eng = ServingEngine(tm, max_wait_ms=0.0, clock=clk)
    fut = eng.submit(_requests([3], seed=4)[0], deadline_ms=5.0)
    split = eng.submit(_requests([40], seed=5)[0], deadline_ms=5.0)
    clk.t = 0.010                          # both deadlines long gone
    eng.start()
    with pytest.raises(DeadlineExceeded, match="no dispatch burned"):
        fut.result(timeout=30)
    with pytest.raises(DeadlineExceeded):
        split.result(timeout=30)
    snap = eng.stats()
    assert snap["expired"] == 2 and snap["dispatches"] == 0
    req = _requests([4], seed=6)[0]
    out = eng.submit(req).result(timeout=30)
    eng.stop()
    np.testing.assert_array_equal(out, tm.predict(req, batch_size=BS))
    snap = eng.stats()
    assert snap["requests"] == 1 and snap["health"] == "stopped"


def test_reject_admission_and_stats_reconcile(models):
    _, tm = models
    eng = ServingEngine(tm, max_batch=4, max_wait_ms=1e6,
                        max_queue_rows=8, admission="reject")
    reqs = _requests([4, 4, 2, 3], seed=7)
    futs = [eng.submit(r) for r in reqs[:2]]   # bound reached
    with pytest.raises(OverloadError, match="rejected"):
        eng.submit(reqs[2])
    assert eng.stats()["rejected"] == 1
    assert eng.health == "starting"
    eng.start()
    outs = [f.result(timeout=30) for f in futs]
    eng.drain(timeout=30)
    with pytest.raises(OverloadError, match="not admitting"):
        eng.submit(reqs[3])
    want = tm.predict(np.concatenate(reqs[:2]), batch_size=BS)
    np.testing.assert_array_equal(np.concatenate(outs), want)
    snap = eng.stats()
    assert snap["requests"] == 2 and snap["rejected"] == 2
    assert snap["submitted"] == (
        snap["requests"] + snap["rejected"] + snap["shed"]
        + snap["expired"] + snap["errors"] + snap["cancelled"])
    assert "completed" not in snap


def test_shed_cancel_and_stop_before_start_reconcile(models):
    _, tm = models
    eng = ServingEngine(tm, max_batch=4, max_wait_ms=1e6,
                        max_queue_rows=8, admission="shed_oldest")
    reqs = _requests([4, 4, 4], seed=8)
    doomed = eng.submit(reqs[0])
    second = eng.submit(reqs[1])
    kept = eng.submit(reqs[2])              # sheds `doomed`
    with pytest.raises(SheddedError, match="shed after queueing"):
        doomed.result(timeout=5)
    assert kept.cancel()                    # client cancel while queued
    eng.stop()                              # never started
    with pytest.raises(SheddedError, match="before it was started"):
        second.result(timeout=5)
    snap = eng.stats()
    assert (snap["shed"], snap["cancelled"], snap["submitted"]) == (2, 1, 3)
    assert snap["submitted"] == (
        snap["requests"] + snap["rejected"] + snap["shed"]
        + snap["expired"] + snap["errors"] + snap["cancelled"])


def test_engine_requires_an_initialized_model():
    m = ft.FFModel(ft.FFConfig(batch_size=4), device="cpu")
    m.dense(m.create_tensor((4, 3)), 2)
    m.compile()
    with pytest.raises(RuntimeError, match="init_layers"):
        ServingEngine(m)


@pytest.mark.parametrize("max_batch,spec", [
    (1, ""), (2, ""), (7, ""), (16, ""), (64, ""), (16, "4,2,16"),
    (64, "3,9"), (8, "8")])
def test_bucket_helpers_match_jax(max_batch, spec):
    want = jbatcher.derive_buckets(max_batch, spec)
    assert tbatcher.derive_buckets(max_batch, spec) == want
    for n in range(1, 2 * max_batch + 3):
        assert (tbatcher.bucket_for(n, want)
                == jbatcher.bucket_for(n, want))
        assert (tbatcher.split_sizes(n, max_batch)
                == jbatcher.split_sizes(n, max_batch))


@pytest.mark.parametrize("bad", [(0, ""), (4, "8"), (4, "x"), (4, "0,2")])
def test_bucket_helpers_refuse_like_jax(bad):
    with pytest.raises(ValueError):
        jbatcher.derive_buckets(*bad)
    with pytest.raises(ValueError):
        tbatcher.derive_buckets(*bad)


def test_quantiles_match_jax():
    rng = np.random.default_rng(9)
    for n in (0, 1, 2, 20, 101):
        xs = list(rng.random(n))
        a, b = quantiles(xs), jax_quantiles(xs)
        assert a.keys() == b.keys()
        for q in a:
            assert (a[q] == b[q]) or (a[q] != a[q] and b[q] != b[q])


def _script(mod, errors, admission):
    """One scripted admission/priority/deadline sequence through a
    MicroBatcher of module ``mod`` on a fake clock; returns the log of
    what happened to each request and each batch."""
    clk = FakeClock()
    b = mod.MicroBatcher(max_batch=4, max_wait_ms=1.0, clock=clk,
                         max_queue_rows=8, admission=admission,
                         starvation_ms=100.0)
    log = []

    def req(tag, n, priority, deadline):
        def on_done(out, now):
            log.append((tag, type(out).__name__))
            return True
        return mod.Request((np.zeros((n, 1)),), n, on_done, clk(),
                           deadline=deadline, priority=priority)

    steps = [("a", 2, 0, None), ("b", 2, 5, None), ("c", 4, 0, 0.003),
             ("d", 2, 5, None), ("e", 2, 1, None), ("f", 4, 9, None)]
    for i, (tag, n, pri, dl) in enumerate(steps):
        clk.t = i * 0.001
        try:
            b.submit(req(tag, n, pri, dl))
            log.append((tag, "queued"))
        except errors.OverloadError:
            log.append((tag, "rejected"))
    clk.t = 0.2
    while True:
        batch = b.poll()
        if not batch:
            break
        log.append(("batch", [r.priority for r in batch],
                    [r.n for r in batch]))
    log.append(("peak", b.peak_rows, b.queue_depth))
    return log


@pytest.mark.parametrize("admission", ["reject", "shed_oldest"])
def test_micro_batcher_behaves_like_jax(admission):
    got = _script(tbatcher, terrors, admission)
    assert got == _script(jbatcher, jerrors, admission)
    assert any(entry[0] == "batch" for entry in got)


def test_micro_batcher_priority_order_like_jax():
    out = []
    for mod in (tbatcher, jbatcher):
        clk = FakeClock()
        b = mod.MicroBatcher(max_batch=4, max_wait_ms=0.0, clock=clk,
                             max_queue_rows=8, admission="block")
        for i, pri in enumerate((0, 3, 1, 3)):
            clk.t = i * 0.001
            b.submit(mod.Request((None,), 2, lambda o, t: True, clk(),
                                 priority=pri))
        b.close()
        out.append([[r.t_submit for r in b.poll()] for _ in range(2)]
                   + [b.peak_rows])
    assert out[0] == out[1] == [[0.001, 0.003], [0.002, 0.0], 8]


def test_bf16_engine_returns_float32_rows_equal_to_predict():
    """numpy has no bfloat16: bf16 results come back as their exact
    float32 upcast, from the engine and from predict alike."""
    cfg = ft.FFConfig(batch_size=BS, compute_dtype="bfloat16")
    m = ft.FFModel(cfg, device="cpu")
    t = m.dense(m.create_tensor((BS, NFEAT), name="x"), NCLS)
    m.softmax(t)
    m.compile()
    m.init_layers(seed=1)
    req = _requests([5], seed=10)[0]
    with ServingEngine(m, max_batch=8) as eng:
        out = eng.submit(req).result(timeout=30)
    want = m.predict(req, batch_size=8)
    assert out.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(out, want)
    # every value is a bfloat16 value: its low 16 bits are zero
    assert not np.any(out.view(np.uint32) & 0xFFFF)
