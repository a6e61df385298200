"""The port's GenerationEngine against the JAX package's, on the CPU.

A 2-layer, 32-wide causal LM (vocab 61, seq 32) and a 1-layer LSTM LM
are built in both packages with the JAX weights carried across
(``interop.params_from_jax_numpy``), in float32.  The JAX engines run
once, in module-scoped fixtures.  Greedy tokens of the port's engine
must equal the JAX engine's and a port reference decode (the full
forward over the padded prefix, argmax at the last position), with the
prefix cache on and off and with whole and chunked prefill.  Then the
engine's own behaviour: EOS, continuous batching, cancel while queued,
mid-stream and during prefill, a queued deadline, admission reject, KV
exhaustion shedding one stream, prefix eviction under pool pressure,
the decoder's refusals, the features not ported yet and the JAX
engine's refusals (``serve_quantize``; an unknown ``spec_policy``), a
draft model served (speculative decoding, ``tests/test_torch_speculative.py``
holds it in full), and
``serve_spec_gamma=2`` without a draft served as plain decode; sampled decode
replays per seed, temperature 0 is greedy, and seeds differ.
"""

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu.models import build_lstm_lm as jax_build_lstm_lm
from flexflow_tpu.models import build_transformer_lm as jax_build_lm
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.serving.generation import \
    GenerationEngine as JaxGenerationEngine
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.serving import (DeadlineExceeded,
                                        GenerationCancelled,
                                        GenerationEngine, GraphDecoder,
                                        KVCacheExhausted, OverloadError,
                                        SamplingParams, SheddedError)

VOCAB = 61
SEQ = 32
LM = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, seq_len=SEQ,
          vocab_size=VOCAB)
LSTM_LM = dict(vocab_size=VOCAB, embed_dim=24, hidden_dim=24, num_layers=1,
               seq_len=SEQ)


def _pair(jax_builder, port_builder, kw, seed):
    jcfg = ff.FFConfig(batch_size=4, compute_dtype="float32", seed=seed)
    jm = jax_builder(jcfg, **kw)[0]
    jm.compile(ff.SGDOptimizer(lr=0.01), mesh=MachineMesh({"n": 1}))
    jm.init_layers(seed=seed)
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=seed)
    tm = port_builder(cfg, device="cpu", **kw)[0]
    tm.compile()
    tm.init_layers(seed=seed)
    interop.params_from_jax_numpy(
        tm, {p.name: jm.get_weights(p.name) for p in jm.parameters})
    return jm, tm


def reference_decode(model, prompt, max_new):
    """The full forward over the padded prefix at every step, argmax at
    the last position."""
    toks = [int(t) for t in prompt]
    for _ in range(max_new):
        padded = np.zeros((2, SEQ), np.int32)
        padded[0, :len(toks)] = toks
        probs = model.predict([padded], batch_size=2)
        toks.append(int(np.argmax(probs[0, len(toks) - 1])))
    return toks[len(prompt):]


def _run(engine_cls, model, prompts, max_new, **kw):
    """Tokens of ``prompts`` through a fresh engine, and the engine, whose
    stats are read once its dispatcher has stopped (a future resolves
    just before its counter moves)."""
    eng = engine_cls(model, **kw)
    with eng:
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        outs = [[int(t) for t in s.result(timeout=120)] for s in streams]
    return outs, eng


@pytest.fixture(scope="module")
def lms():
    return _pair(jax_build_lm, ft.build_transformer_lm, LM, 0)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, VOCAB, int(rng.integers(2, 9))).astype(np.int32)
            for _ in range(6)]


@pytest.fixture(scope="module")
def shared_prompts():
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, VOCAB, 20).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(1, VOCAB, n).astype(
        np.int32)]) for n in (3, 5, 2, 4)]


@pytest.fixture(scope="module")
def jax_tokens(lms, prompts, shared_prompts):
    """The JAX engine's greedy tokens, one engine run."""
    outs, _ = _run(JaxGenerationEngine, lms[0], prompts + shared_prompts,
                   6, slots=2)
    return outs[:len(prompts)], outs[len(prompts):]


@pytest.fixture(scope="module")
def refs(lms, prompts, shared_prompts):
    tm = lms[1]
    return ([reference_decode(tm, p, 6) for p in prompts],
            [reference_decode(tm, p, 6) for p in shared_prompts])


def test_greedy_tokens_equal_jax_engine_and_reference(lms, prompts,
                                                      jax_tokens, refs):
    eng = GenerationEngine(lms[1], slots=2, max_new_tokens=6)
    with eng:
        streams = [eng.submit(p) for p in prompts]
        iterated = [list(s) for s in streams]
        finals = [[int(t) for t in s.result(timeout=120)] for s in streams]
    assert finals == jax_tokens[0]
    assert finals == refs[0]
    assert iterated == finals
    snap = eng.stats()
    assert snap["requests"] == len(prompts)
    assert snap["tokens"] == 6 * len(prompts)
    assert snap["prefills"] == len(prompts)
    assert snap["errors"] == 0 and snap["kv_cache_bytes"] > 0
    assert snap["tpot_p50_ms"] is not None and snap["ttft_p50_ms"] > 0
    assert eng._pool.pages_in_use == 0


@pytest.mark.parametrize("cache", ["on", "off"])
@pytest.mark.parametrize("chunk", [0, 3, 4])
def test_prefix_cache_and_chunking_keep_tokens(lms, shared_prompts,
                                               jax_tokens, refs, cache,
                                               chunk):
    outs, eng = _run(GenerationEngine, lms[1], shared_prompts, 6, slots=2,
                     prefix_cache=cache, prefill_chunk=chunk)
    snap = eng.stats()
    assert outs == jax_tokens[1]
    assert outs == refs[1]
    if cache == "on":
        # the 20-token prefix holds one full 16-token page
        assert snap["prefix_hit_tokens"] >= 16
        assert snap["prefix_hit_rate"] > 0
    else:
        assert snap["prefix_hit_tokens"] == 0
    if chunk:
        assert snap["prefill_chunks"] > len(shared_prompts)


def test_lstm_lm_tokens_equal_jax_engine_and_reference():
    jm, tm = _pair(jax_build_lstm_lm, ft.build_lstm_lm, LSTM_LM, 5)
    rng = np.random.default_rng(6)
    ps = [rng.integers(1, VOCAB, int(n)).astype(np.int32)
          for n in (4, 7, 2)]
    jouts, _ = _run(JaxGenerationEngine, jm, ps, 5, slots=2)
    outs, eng = _run(GenerationEngine, tm, ps, 5, slots=2,
                     prefill_chunk=3)
    snap = eng.stats()
    assert outs == jouts
    assert outs == [reference_decode(tm, p, 5) for p in ps]
    # cell state does not page: whole-prompt chunks, no prefix cache
    assert snap["prefill_chunk"] == 0 and snap["prefix_cache"] == "off"


def test_eos_stops_stream(lms, prompts, refs):
    eos = refs[0][0][2]
    with GenerationEngine(lms[1], slots=2, eos_id=int(eos)) as eng:
        out = eng.submit(prompts[0], max_new_tokens=6).result(timeout=120)
    stop = refs[0][0].index(eos) + 1
    assert [int(t) for t in out] == refs[0][0][:stop]


def test_continuous_batching_joins_mid_flight(lms, prompts, refs):
    eng = GenerationEngine(lms[1], slots=2)
    with eng:
        long_s = eng.submit(prompts[0], max_new_tokens=24)
        shorts = [eng.submit(p, max_new_tokens=2) for p in prompts[1:5]]
        for s in shorts:
            s.result(timeout=120)
        assert not long_s.future.done()
        assert len(long_s.result(timeout=120)) == 24
    assert [[int(t) for t in s.result()] for s in shorts] == \
        [r[:2] for r in refs[0][1:5]]


def test_cancel_while_queued_never_prefills(lms, prompts):
    eng = GenerationEngine(lms[1], slots=2)
    s = eng.submit(prompts[0], max_new_tokens=4)
    s.cancel()
    assert s.future.cancelled()
    assert list(s) == []
    eng.stop()
    assert eng.stats()["cancelled"] == 1


def test_cancel_mid_generation_frees_slot(lms, prompts, refs):
    eng = GenerationEngine(lms[1], slots=2)
    with eng:
        victim = eng.submit(prompts[0], max_new_tokens=24)
        other = eng.submit(prompts[1], max_new_tokens=6)
        it = iter(victim)
        got = [next(it), next(it)]
        victim.cancel()
        with pytest.raises(GenerationCancelled):
            victim.result(timeout=120)
        assert len(got) == 2
        assert [int(t) for t in other.result(timeout=120)] == refs[0][1]
        late = eng.submit(prompts[2], max_new_tokens=4)
        assert [int(t) for t in late.result(timeout=120)] == refs[0][2][:4]
    snap = eng.stats()
    assert snap["cancelled"] == 1 and snap["errors"] == 0
    assert eng._pool.pages_in_use == 0


def test_cancel_during_prefill_frees_pages(lms, prompts, refs,
                                           monkeypatch):
    """A cancel landing inside a prefill chunk's dispatch frees the slot
    and its pages at the next boundary; only that stream fails."""
    eng = GenerationEngine(lms[1], slots=2, max_new_tokens=6,
                           prefix_cache="off", prefill_chunk=2)
    state = {}
    orig = eng._decoder.prefill_fn

    def hooked(bucket):
        fn = orig(bucket)

        def wrapper(*a, **kw):
            v = state.get("stream")
            if v is not None and not state.get("fired"):
                state["fired"] = True
                v.cancel()
            return fn(*a, **kw)

        return wrapper

    monkeypatch.setattr(eng._decoder, "prefill_fn", hooked)
    with eng:
        ok = eng.submit(prompts[0])
        list(ok)
        state["stream"] = victim = eng.submit(prompts[1])
        with pytest.raises(GenerationCancelled):
            victim.result(timeout=120)
        late = eng.submit(prompts[2])
        assert [int(t) for t in late.result(timeout=120)] == refs[0][2]
    assert eng._pool.pages_in_use == 0
    snap = eng.stats()
    assert snap["cancelled"] == 1 and snap["errors"] == 0
    assert [int(t) for t in ok.result()] == refs[0][0]


def test_queued_deadline_expires_before_prefill(lms, prompts):
    eng = GenerationEngine(lms[1], slots=2)
    with eng:
        longs = [eng.submit(p, max_new_tokens=20) for p in prompts[:2]]
        doomed = eng.submit(prompts[2], max_new_tokens=4,
                            deadline_ms=0.001)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=10)
        for s in longs:
            s.result(timeout=120)
    snap = eng.stats()
    assert snap["expired"] == 1 and snap["prefills"] == 2


def test_admission_reject_and_stop_before_start(lms, prompts):
    eng = GenerationEngine(lms[1], slots=2, max_queue_requests=2,
                           admission="reject", max_new_tokens=4)
    s1 = eng.submit(prompts[0])
    s2 = eng.submit(prompts[1])
    with pytest.raises(OverloadError):
        eng.submit(prompts[2])
    assert eng.stats()["rejected"] == 1
    eng.stop()
    for s in (s1, s2):
        with pytest.raises(SheddedError):
            s.result(timeout=10)
    with pytest.raises(RuntimeError):
        eng.start()


def test_kv_exhaustion_sheds_only_one_stream(lms):
    rng = np.random.default_rng(12)
    ps = [rng.integers(1, VOCAB, 4).astype(np.int32) for _ in range(2)]
    eng = GenerationEngine(lms[1], slots=2, max_new_tokens=20, num_pages=2,
                           prefix_cache="off")
    results = []
    with eng:
        streams = [eng.submit(p) for p in ps]
        for s in streams:
            try:
                results.append([int(t) for t in s.result(timeout=120)])
            except KVCacheExhausted:
                results.append("shed")
    snap = eng.stats()
    assert results.count("shed") == 1
    good = next(i for i, r in enumerate(results) if r != "shed")
    assert results[good] == reference_decode(lms[1], ps[good], 20)
    assert snap["shed"] == 1 and snap["errors"] == 0
    assert eng._pool.pages_in_use == 0


def test_prefix_eviction_under_pool_pressure(lms):
    rng = np.random.default_rng(11)
    ps = [np.concatenate([rng.integers(1, VOCAB, 16).astype(np.int32),
                          rng.integers(1, VOCAB, 3).astype(np.int32)])
          for _ in range(4)]
    outs, eng = _run(GenerationEngine, lms[1], ps, 4, slots=2,
                     num_pages=4, prefix_cache="on")
    snap = eng.stats()
    assert outs == [reference_decode(lms[1], p, 4) for p in ps]
    assert snap["evictions"] >= 1


def test_submit_validation(lms):
    eng = GenerationEngine(lms[1], slots=2)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.ones((SEQ,), np.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match=">= 1"):
        eng.submit(np.ones((4,), np.int32), max_new_tokens=0)
    with pytest.raises(TypeError, match="SamplingParams"):
        eng.submit(np.ones((4,), np.int32), sampling={"temperature": 1.0})
    eng.stop()


def test_decoder_refuses_unsupported_graphs(lms):
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32")
    clf = ft.build_transformer(cfg, num_layers=1, d_model=32, num_heads=2,
                               d_ff=64, seq_len=16, vocab_size=VOCAB,
                               device="cpu")[0]
    clf.compile()
    with pytest.raises(ValueError, match="classifier|per-token"):
        GraphDecoder(clf, 2, 16)
    with pytest.raises(ValueError, match="slots"):
        GraphDecoder(clf, 1, 16)
    bidir = ft.FFModel(cfg, device="cpu")
    t = bidir.create_tensor((4, 16), dtype="int32")
    x = bidir.embedding(t, VOCAB, 32, aggr="none")
    x = bidir.multihead_attention(x, num_heads=2, causal=False)
    bidir.dense(x, VOCAB)
    bidir.compile()
    with pytest.raises(ValueError, match="causal"):
        GraphDecoder(bidir, 2, 16)
    with pytest.raises(ValueError, match="position table"):
        GraphDecoder(lms[1], 2, 64)
    with pytest.raises(ValueError, match="cannot hold"):
        GraphDecoder(lms[1], 2, SEQ, page_size=16, num_pages=1)


def test_unported_features_are_refused(lms, prompts, refs):
    model = lms[1]
    # speculative decoding is ported: a draft is accepted and served
    # (the model as its own draft: every proposal verifies)
    outs, eng = _run(GenerationEngine, model, prompts[:2], 6, slots=2,
                     draft_model=model, spec_gamma=2)
    assert outs == refs[0][:2]
    snap = eng.stats()
    assert snap["spec"] == "on" and snap["draft_dispatches"] > 0
    # without a draft, gamma is 0 and the policy is still checked, as in
    # the JAX engine
    with pytest.raises(ValueError, match="spec_policy"):
        GenerationEngine(model, slots=2, spec_gamma=2, spec_policy="greedy")
    with pytest.raises(NotImplementedError, match="A.8"):
        GenerationEngine.from_strategy(model, "s.pb")
    eng = GenerationEngine(model, slots=2)
    with pytest.raises(NotImplementedError, match="fleet"):
        eng.begin_external_dispatch()
    with pytest.raises(NotImplementedError, match="A.10b"):
        eng.adopt_migrated({})
    eng.stop()
    # refused for good, with the JAX engine's error, on the config and
    # on a model that carries the quantized mark
    model.config.serve_quantize = "int8"
    try:
        with pytest.raises(ValueError, match="dense serving only"):
            GenerationEngine(model, slots=2)
    finally:
        model.config.serve_quantize = ""
    model._quantized = "int8"
    try:
        with pytest.raises(ValueError, match="dense serving only"):
            GenerationEngine(model, slots=2)
    finally:
        del model._quantized


def test_spec_gamma_without_draft_serves_plain_decode_as_jax(lms, prompts,
                                                             jax_tokens):
    """serve_spec_gamma=2 with no draft model: both engines force gamma
    to 0 and serve plain greedy decode, the same tokens."""
    jm, tm = lms
    outs = {}
    for name, model, cls in (("jax", jm, JaxGenerationEngine),
                             ("port", tm, GenerationEngine)):
        model.config.serve_spec_gamma = 2
        try:
            outs[name], _ = _run(cls, model, prompts, 6, slots=2)
        finally:
            model.config.serve_spec_gamma = 0
    assert outs["port"] == outs["jax"] == jax_tokens[0]


def test_sampled_decode_replays_and_temperature_zero_is_greedy(
        lms, prompts, refs):
    def run(params):
        with GenerationEngine(lms[1], slots=2) as eng:
            streams = [eng.submit(p, max_new_tokens=8, sampling=params(i))
                       for i, p in enumerate(prompts[:3])]
            return [[int(t) for t in s.result(timeout=120)]
                    for s in streams]

    def sp(i):
        return SamplingParams(temperature=0.8, top_k=8, top_p=0.9,
                              seed=100 + i)

    a = run(sp)
    assert a == run(sp)
    assert run(lambda i: SamplingParams(temperature=0.0, seed=5)) == \
        [r[:6] + reference_decode(lms[1], p, 8)[6:]
         for r, p in zip(refs[0][:3], prompts[:3])]
    hot1 = run(lambda i: SamplingParams(temperature=1.5, seed=1))
    hot2 = run(lambda i: SamplingParams(temperature=1.5, seed=2))
    assert hot1 != hot2
    assert all(0 <= t < VOCAB for row in a + hot1 for t in row)


def test_concurrent_producers_reconcile(lms, prompts, refs):
    """More producer threads than cores, with a short switch interval:
    every stream gets its reference tokens and the counters reconcile."""
    import os
    import sys
    import threading

    results = {}
    eng = GenerationEngine(lms[1], slots=2, max_new_tokens=6)

    def producer(t):
        for j in range(2):
            i = (t + j) % len(prompts)
            out = eng.submit(prompts[i]).result(timeout=120)
            results[(t, j)] = (i, [int(x) for x in out])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with eng:
            threads = [threading.Thread(target=producer, args=(t,))
                       for t in range((os.cpu_count() or 4) + 4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    snap = eng.stats()
    assert len(results) == 2 * len(threads)
    assert all(out == refs[0][i] for i, out in results.values())
    assert snap["submitted"] == snap["requests"] == len(results)
    assert eng._pool.pages_in_use == 0


def test_drain_sheds_streams_still_decoding(lms, prompts, monkeypatch):
    """drain(timeout) past its timeout fails the active stream and the
    queued one with SheddedError and returns every page."""
    import time

    eng = GenerationEngine(lms[1], slots=2, max_new_tokens=20)
    orig = eng._decoder.decode_fn

    def slow():
        fn = orig()

        def step(*a):
            time.sleep(0.005)
            return fn(*a)

        return step

    monkeypatch.setattr(eng._decoder, "decode_fn", slow)
    eng.start()
    active = eng.submit(prompts[0])
    it = iter(active)
    next(it)
    queued = [eng.submit(p) for p in prompts[1:4]]
    eng.drain(timeout=0.02)
    for s in [active] + queued:
        with pytest.raises(SheddedError):
            s.result(timeout=30)
    # drain returns once its second join times out; the dispatcher sheds
    # the active stream at its next boundary
    deadline = time.monotonic() + 30
    while eng.stats()["shed"] < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    snap = eng.stats()
    assert snap["shed"] == 4 and snap["requests"] == 0
    assert eng._pool.pages_in_use == 0
    with pytest.raises(OverloadError):
        eng.submit(prompts[0])
