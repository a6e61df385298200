"""Speculative decoding in the port against the JAX package's, on the
CPU, in float32.

Op level (rtol 1e-5, atol 1e-6, weights scaled 0.1 as
``test_torch_generation.py`` does): ``MultiHeadAttention.verify_paged``
and ``PositionEmbedding.decode_window`` against the JAX ops at every
window offset (writes through the sentinel dropped on the host by
``kept_window_writes``, pages no table names bit-unchanged), and the
window rows against the port's own decode steps.  Sampling:
``residual_probs`` within 1e-6 of JAX; ``speculative_accept`` fed the
JAX accept uniforms gives the JAX ``n_accept`` and tokens (the residual
draw is one-hot there, so the bits do not matter); the emitted tokens
of ``speculative_accept`` and ``speculative_sample`` follow the target
distribution within total variation 0.02 over 40,000 draws.

Engine level (the JAX tests ``tests/test_generation.py:944-1160``): a
2-layer, 32-wide causal LM (vocab 61, seq 32) in both packages with the
JAX weights carried across, and two drafts: the target's own weights
(every proposal verifies) and a divergent one (seed 7).  Greedy
speculative tokens equal the JAX speculative engine's and plain greedy
at gamma 2, 3 and 4 for both drafts; then the collapse demotion (one
``serve_health`` event, the draft pool freed, no stream failed), a draft
failure demoting, EOS and ``max_new_tokens`` inside a window, the
adaptive policy, sampled replay, the stats keys, ``draft_kv_cache_bytes``
equal to the draft pool's allocation, and the configuration checks with
the JAX texts.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.models import build_transformer_lm as jax_build_lm
from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.attention import MultiHeadAttention as JaxMHA
from flexflow_tpu.ops.attention import PositionEmbedding as JaxPosEmb
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.serving.generation import \
    GenerationEngine as JaxGenerationEngine
from flexflow_tpu.serving.generation import sampling as jsampling
from flexflow_tpu.tensor import Tensor as JaxTensor
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.fflogger import capture_events
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops.attention import (MultiHeadAttention,
                                              PositionEmbedding)
from flexflow_tpu_torch.serving import GenerationEngine, SamplingParams
from flexflow_tpu_torch.serving.generation import sampling
from flexflow_tpu_torch.serving.generation.decoder import (
    kept_window_writes, kept_writes)
from flexflow_tpu_torch.tensor import Tensor

RTOL, ATOL = 1e-5, 1e-6
N, S, D, H = 2, 16, 32, 4
PAGE = 4
VOCAB = 61
SEQ = 32
LM = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, seq_len=SEQ,
          vocab_size=VOCAB)


def _jctx():
    return JaxOpContext(training=False, compute_dtype="float32", mesh=None)


def _ctx():
    return OpContext(compute_dtype="float32")


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _op_pair(jcls, cls, shape, seed):
    """The same op in both packages with the same random weights (scaled
    0.1) and a random input."""
    jop = jcls("op", JaxTensor(shape, name="x"))
    op = cls("op", Tensor(shape, name="x"))
    rng = np.random.default_rng(seed)
    params = {w.name: (0.1 * rng.standard_normal(w.shape)).astype(np.float32)
              for w in jop.weights}
    assert sorted(params) == sorted(w.name for w in op.weights)
    x = rng.standard_normal(shape).astype(np.float32)
    return (jop, {k: jnp.asarray(v) for k, v in params.items()},
            op, {k: torch.from_numpy(v) for k, v in params.items()}, x)


def _mha(name, t):
    return name, t, t, t, D, H


# ---------------------------------------------------------------------
# ops: the verify window
# ---------------------------------------------------------------------
@pytest.mark.parametrize("w", [2, 3, 4])
def test_verify_paged_every_offset_matches_jax_and_decode(w):
    jop, jp, op, tp, x = _op_pair(
        lambda n, t: JaxMHA(*_mha(n, t), causal=True),
        lambda n, t: MultiHeadAttention(*_mha(n, t), causal=True),
        (N, S, D), seed=1)
    pps = S // PAGE
    n_pages = 2 * pps + 3
    rng = np.random.default_rng(2)
    perm = rng.permutation(n_pages)
    # slot N is inactive: sentinel table and writes
    table = np.full((N + 1, pps), n_pages, np.int32)
    table[0], table[1] = perm[:pps], perm[pps:2 * pps]
    kp = rng.standard_normal((n_pages, PAGE, H, D // H)).astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    xs = np.concatenate([x, rng.standard_normal((1, S, D)).astype(
        np.float32)])
    jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    dkp, dvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for t0 in range(0, S - w + 1):
        pos = np.array([t0, t0, 0], np.int32)
        wp = np.full((N + 1, w), n_pages, np.int32)
        wr = np.zeros((N + 1, w), np.int32)
        for i in range(N):
            for c in range(w):
                wp[i, c] = table[i, (t0 + c) // PAGE]
                wr[i, c] = (t0 + c) % PAGE
        args = (table, pos, wp, wr)
        (jo,), jkp, jvp = jop.verify_paged(
            jp, jnp.asarray(xs[:, t0:t0 + w]), jkp, jvp,
            *map(jnp.asarray, args), _jctx())
        kept = kept_window_writes(wp, wr, n_pages)
        assert kept[0].tolist() == [0] * w + [1] * w
        (o,), kp2, vp2 = op.verify_paged(
            tp, torch.from_numpy(xs[:, t0:t0 + w]), tkp, tvp,
            *(torch.from_numpy(a) for a in (table, pos, *kept)), _ctx())
        assert kp2 is tkp and vp2 is tvp
        _close(o[:N], np.asarray(jo)[:N], f"t0={t0}")
        _close(tkp, jkp, f"t0={t0} pool")
        _close(tvp, jvp, f"t0={t0} pool")
        # window row c is the decode step at t0 + c (its own pools)
        for c in range(w):
            t = t0 + c
            dk = kept_writes(wp[:, c], wr[:, c], n_pages)
            (od,), _, _ = op.decode_paged(
                tp, torch.from_numpy(xs[:, t:t + 1]), dkp, dvp,
                torch.from_numpy(table),
                torch.from_numpy(np.array([t, t, 0], np.int32)),
                *(torch.from_numpy(a) for a in dk), _ctx())
            _close(o[:N, c], od[:N, 0], f"t0={t0} row {c} vs decode")
    named = set(table[:N].reshape(-1).tolist())
    for pg in set(range(n_pages)) - named:
        assert torch.equal(tkp[pg], torch.from_numpy(kp[pg]))
        assert torch.equal(tvp[pg], torch.from_numpy(vp[pg]))


def test_verify_paged_rejected_rows_stay_masked():
    """A round writes its whole window; the next round, one position
    later, must not see the rows past its own positions (the mask is
    keyed on global positions, so stale rows are invisible)."""
    _, _, op, tp, x = _op_pair(
        lambda n, t: JaxMHA(*_mha(n, t), causal=True),
        lambda n, t: MultiHeadAttention(*_mha(n, t), causal=True),
        (N, S, D), seed=3)
    n_pages = S // PAGE
    table = torch.stack([torch.arange(n_pages),
                         torch.arange(n_pages, 2 * n_pages).flip(0)])
    outs = {}
    for junk in (0.0, 100.0):
        kp = torch.zeros((2 * n_pages, PAGE, H, D // H))
        vp = torch.zeros_like(kp)
        # positions 0..5 are the accepted history; 6..9 a rejected
        # window's rows, filled with junk
        for i in range(N):
            for p in range(10):
                val = 1.0 if p < 6 else junk
                kp[table[i, p // PAGE], p % PAGE] = val * (i + 1)
                vp[table[i, p // PAGE], p % PAGE] = val
        pos = torch.tensor([6, 6])
        ws = torch.arange(N).repeat_interleave(2)
        wc = torch.arange(2).repeat(N)
        p = 6 + wc
        (o,), _, _ = op.verify_paged(
            tp, torch.from_numpy(x[:, 6:8]), kp, vp, table, pos, ws, wc,
            table[ws, p // PAGE], p % PAGE, _ctx())
        outs[junk] = o
    assert torch.equal(outs[0.0], outs[100.0])


def test_decode_window_matches_jax_and_decode():
    jop, jp, op, tp, x = _op_pair(JaxPosEmb, PositionEmbedding, (N, S, D),
                                  seed=5)
    for w in (2, 4):
        for t0 in range(S - w + 1):
            pos = np.array([t0, max(0, t0 - 1)], np.int32)
            got = op.decode_window(tp, torch.from_numpy(x[:, :w]),
                                   torch.from_numpy(pos), _ctx())[0]
            want = jop.decode_window(jp, jnp.asarray(x[:, :w]),
                                     jnp.asarray(pos), _jctx())[0]
            _close(got, want, f"w={w} t0={t0}")
            for c in range(w):
                row = op.decode(tp, torch.from_numpy(x[:, c:c + 1]),
                                torch.from_numpy(pos + c), _ctx())[0]
                assert torch.equal(got[:, c], row[:, 0])


def test_kept_window_writes_drop_the_sentinel():
    wp = np.array([[3, 4], [9, 9], [5, 9]], np.int32)
    wr = np.array([[1, 2], [0, 0], [3, 0]], np.int32)
    slots, cols, pages, rows = kept_window_writes(wp, wr, 9)
    assert slots.tolist() == [0, 0, 2] and cols.tolist() == [0, 1, 0]
    assert pages.tolist() == [3, 4, 5] and rows.tolist() == [1, 2, 3]


# ---------------------------------------------------------------------
# sampling: the residual, the accept rule, the target distribution
# ---------------------------------------------------------------------
def _dirichlet(rng, shape):
    return rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(
        np.float32)


def test_residual_probs_matches_jax():
    rng = np.random.default_rng(10)
    p = _dirichlet(rng, (6, 17))
    q = _dirichlet(rng, (6, 17))
    q[2] = p[2]                              # zero residual: falls back to p
    got = sampling.residual_probs(torch.from_numpy(p), torch.from_numpy(q))
    want = jsampling.residual_probs(jnp.asarray(p), jnp.asarray(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert torch.equal(got[2], torch.from_numpy(p[2]))


def test_speculative_accept_on_the_jax_uniforms():
    """The JAX uniforms through the port's arithmetic: the same accept
    counts and tokens.  The target rows are one-hot (greedy) at the
    positions a residual may be drawn, so the residual is determined and
    the draw's bits (threefry against the counter hash) do not enter."""
    rng = np.random.default_rng(11)
    n, w, v = 64, 4, 9
    p = _dirichlet(rng, (n, w, v))
    q = _dirichlet(rng, (n, w, v))
    d = np.stack([[rng.choice(v, p=q[i, t]) for t in range(w)]
                  for i in range(n)]).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), 2 * n * w)
    akeys = keys[:n * w].reshape(n, w, 2)
    rkeys = keys[n * w:].reshape(n, w, 2)
    u = np.array(jsampling.uniform_01(akeys))
    # n_accept on random p and q
    jn, _ = jsampling.speculative_accept(jnp.asarray(d), jnp.asarray(p),
                                         jnp.asarray(q), akeys, rkeys)
    tn = sampling.accept_count(torch.from_numpy(d), torch.from_numpy(p),
                               torch.from_numpy(q), torch.from_numpy(u))
    assert tn.tolist() == np.asarray(jn).tolist()
    assert 0 < int(tn.sum()) < n * w
    # tokens with one-hot targets: the rule degenerates to greedy
    ph = np.eye(v, dtype=np.float32)[rng.integers(0, v, (n, w))]
    ph[::3] = np.eye(v, dtype=np.float32)[d[::3]]   # some all-accept rows
    jn, jout = jsampling.speculative_accept(
        jnp.asarray(d), jnp.asarray(ph), jnp.asarray(q), akeys, rkeys)
    tn, tout = sampling.speculative_accept(
        torch.from_numpy(d), torch.from_numpy(ph), torch.from_numpy(q),
        torch.zeros(n, dtype=torch.int64),
        torch.arange(n * w).reshape(n, w), u=torch.from_numpy(u))
    assert tn.tolist() == np.asarray(jn).tolist()
    assert tout.tolist() == np.asarray(jout).tolist()
    assert (tn == w).any() and (tn < w).any()


def test_speculative_accept_preserves_target_distribution():
    """Tokens through draft -> accept -> residual follow the target p,
    not the draft q (TV <= 0.02 over 40,000 draws), for the windowed
    rule the engine runs and the single-position sampler, and the accept
    rate is sum(min(p, q)); emitting from q would be far off."""
    v, n = 8, 40_000
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(v)).astype(np.float32))
    q = torch.from_numpy(rng.dirichlet(np.ones(v)).astype(np.float32))
    seeds = torch.full((n,), 42, dtype=torch.int64)
    pos = torch.arange(n)
    d = sampling.categorical(q.expand(n, -1), seeds, pos,
                             sampling.STREAM_DRAFT)[:, None]
    n_acc, out = sampling.speculative_accept(
        d, p.expand(n, 1, -1), q.expand(n, 1, -1), seeds, pos[:, None])
    emp = np.bincount(out[:, 0].numpy(), minlength=v) / n
    assert 0.5 * np.abs(emp - p.numpy()).sum() < 0.02
    assert abs(float(n_acc.double().mean())
               - float(torch.minimum(p, q).sum())) < 0.02
    assert 0.5 * float((p - q).abs().sum()) > 0.1
    ref = sampling.speculative_sample(p, q, n, seed=7)
    emp_ref = np.bincount(ref.numpy(), minlength=v) / n
    assert 0.5 * np.abs(emp_ref - p.numpy()).sum() < 0.02


# ---------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------
def _pair(seed):
    jcfg = ff.FFConfig(batch_size=4, compute_dtype="float32", seed=seed)
    jm = jax_build_lm(jcfg, **LM)[0]
    jm.compile(ff.SGDOptimizer(lr=0.01), mesh=MachineMesh({"n": 1}))
    jm.init_layers(seed=seed)
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=seed)
    tm = ft.build_transformer_lm(cfg, device="cpu", **LM)[0]
    tm.compile()
    tm.init_layers(seed=seed)
    interop.params_from_jax_numpy(
        tm, {p.name: jm.get_weights(p.name) for p in jm.parameters})
    return jm, tm


@pytest.fixture(scope="module")
def lms():
    return _pair(0)


@pytest.fixture(scope="module")
def draft_lm():
    # the target's seed, so the same weights: every proposal verifies
    return _pair(0)


@pytest.fixture(scope="module")
def draft_off():
    # a divergent draft: the correction path carries the streams
    return _pair(7)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, VOCAB, int(rng.integers(2, 9))).astype(np.int32)
            for _ in range(6)]


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


def _run(cls, model, prompts, max_new=6, sampling_of=None, **kw):
    """Tokens of ``prompts`` through a fresh engine, and its stats, read
    once the dispatcher has stopped."""
    eng = cls(model, slots=2, **kw)
    with eng:
        streams = [eng.submit(p, max_new_tokens=max_new,
                              sampling=(sampling_of(i) if sampling_of
                                        else None))
                   for i, p in enumerate(prompts)]
        outs = [[int(t) for t in s.result(timeout=180)] for s in streams]
    return outs, eng.stats(), eng


@pytest.fixture(scope="module")
def plain(lms, prompts):
    outs, _, _ = _run(GenerationEngine, lms[1], prompts)
    assert outs == [reference_decode(lms[1], p, 6) for p in prompts]
    return outs


@pytest.mark.parametrize("gamma", [2, 3, 4])
@pytest.mark.parametrize("which", ["self", "divergent"])
def test_spec_greedy_equals_jax_spec_and_plain(lms, draft_lm, draft_off,
                                               prompts, plain, gamma,
                                               which):
    drafts = draft_lm if which == "self" else draft_off
    jouts, jsnap, _ = _run(JaxGenerationEngine, lms[0], prompts,
                           draft_model=drafts[0], spec_gamma=gamma)
    outs, snap, eng = _run(GenerationEngine, lms[1], prompts,
                           draft_model=drafts[1], spec_gamma=gamma)
    assert outs == plain
    assert outs == jouts
    assert snap["draft_dispatches"] > 0
    # the JAX engine's stats lose the speculation view at stop; its
    # counters stay.  A divergent draft collapses once 64 proposals
    # have been judged (gamma 3 and 4 here), in both engines
    assert snap["spec_fallbacks"] == jsnap["spec_fallbacks"]
    assert snap["spec"] == ("fallback" if snap["spec_fallbacks"] else "on")
    if which == "self":
        # identical weights: the draft's argmax is the target's
        assert snap["accept_rate"] == jsnap["accept_rate"] == 1.0
        assert snap["spec_fallbacks"] == 0
    else:
        assert snap["accept_rate"] < 0.5 and jsnap["accept_rate"] < 0.5
    assert eng._pool.pages_in_use == 0
    assert eng._draft_pool is None or eng._draft_pool.pages_in_use == 0


@pytest.mark.parametrize("cache", ["on", "off"])
def test_spec_prefix_cache_keeps_tokens(lms, draft_lm, cache):
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, VOCAB, 20).astype(np.int32)
    shared = [np.concatenate([prefix, rng.integers(1, VOCAB, n).astype(
        np.int32)]) for n in (3, 5, 2)]
    outs, snap, _ = _run(GenerationEngine, lms[1], shared,
                         draft_model=draft_lm[1], spec_gamma=4,
                         prefix_cache=cache)
    assert outs == [reference_decode(lms[1], p, 6) for p in shared]
    assert (snap["prefix_hit_tokens"] > 0) == (cache == "on")
    assert snap["accept_rate"] == 1.0


def _serve_events(events):
    return [e for e in events if e["event"] == "serve_health"
            and e.get("component") == "speculation"]


def test_spec_accept_collapse_demotes_to_plain(lms, draft_off, prompts,
                                               plain, monkeypatch):
    monkeypatch.setattr(GenerationEngine, "_SPEC_COLLAPSE_MIN_PROPOSED", 8)
    monkeypatch.setattr(GenerationEngine, "_SPEC_COLLAPSE_ACCEPT", 0.9)
    refs = [reference_decode(lms[1], p, 8) for p in prompts[:3]]
    eng = GenerationEngine(lms[1], slots=2, draft_model=draft_off[1],
                           spec_gamma=4)
    with capture_events("serve") as events:
        with eng:
            pool = weakref.ref(next(iter(
                eng._draft_caches.values()))["k"])
            streams = [eng.submit(p, max_new_tokens=8) for p in prompts[:3]]
            outs = [[int(t) for t in s.result(timeout=180)]
                    for s in streams]
    snap = eng.stats()
    assert outs == refs
    assert snap["spec"] == "fallback" and snap["spec_fallbacks"] == 1
    assert snap["errors"] == 0 and snap["draft_kv_cache_bytes"] == 0
    ev = _serve_events(events)
    assert len(ev) == 1
    assert ev[0]["reason"] == "accept_collapse"
    assert ev[0]["status"] == "fallback"
    assert ev[0]["accept_ewma"] < 0.9
    # the draft pool is released
    assert eng._draft_caches is None and eng._draft_pool is None
    gc.collect()
    assert pool() is None


def test_draft_failure_demotes_and_fails_no_stream(lms, draft_lm, prompts,
                                                   monkeypatch):
    eng = GenerationEngine(lms[1], slots=2, draft_model=draft_lm[1],
                           spec_gamma=2)
    calls = {"n": 0}
    orig = eng._draft_decoder.draft_fn

    def failing(gamma, sampled=False):
        fn = orig(gamma, sampled)

        def wrapped(*a):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("draft step lost")
            return fn(*a)
        return wrapped

    with capture_events("serve") as events:
        with eng:
            monkeypatch.setattr(eng._draft_decoder, "draft_fn", failing)
            streams = [eng.submit(p, max_new_tokens=8) for p in prompts[:2]]
            outs = [[int(t) for t in s.result(timeout=180)]
                    for s in streams]
    assert outs == [reference_decode(lms[1], p, 8) for p in prompts[:2]]
    snap = eng.stats()
    assert snap["spec"] == "fallback" and snap["errors"] == 0
    ev = _serve_events(events)
    assert [e["reason"] for e in ev] == ["draft_error"]
    assert "draft step lost" in ev[0]["error"]


def test_spec_eos_and_max_new_truncate_mid_window(lms, draft_lm, prompts):
    ref = reference_decode(lms[1], prompts[0], 6)
    eng = GenerationEngine(lms[1], slots=2, draft_model=draft_lm[1],
                           spec_gamma=4, eos_id=int(ref[2]))
    with eng:
        out = [int(t) for t in
               eng.submit(prompts[0], max_new_tokens=6).result(timeout=180)]
    assert out == ref[:3]      # stops at (and includes) EOS, mid-window
    outs, _, _ = _run(GenerationEngine, lms[1], prompts[:2], max_new=3,
                      draft_model=draft_lm[1], spec_gamma=4)
    assert outs == [reference_decode(lms[1], p, 3) for p in prompts[:2]]


def test_spec_adaptive_policy_parity(lms, draft_lm, prompts, monkeypatch):
    monkeypatch.setattr(GenerationEngine, "_SPEC_RETUNE_EVERY", 2)
    outs, snap, eng = _run(GenerationEngine, lms[1], prompts[:3],
                           max_new=8, draft_model=draft_lm[1],
                           spec_policy="adaptive", spec_gamma_max=4)
    assert outs == [reference_decode(lms[1], p, 8) for p in prompts[:3]]
    assert snap["spec"] == "on" and snap["draft_dispatches"] > 0
    assert snap["spec_policy"] == "adaptive"
    assert 2 <= snap["spec_gamma"] <= 4
    assert eng._spec_candidates == [2, 4]
    assert set(eng._spec_costs) == {2, 4}


def test_spec_retune_prices_tokens_over_cost(lms, draft_lm):
    eng = GenerationEngine(lms[1], slots=2, draft_model=draft_lm[1],
                           spec_policy="adaptive", spec_gamma_max=6)
    assert eng._spec_candidates == [2, 4, 6]
    eng._spec_costs = {2: 1.0, 4: 1.5, 6: 2.5}
    eng._accept_ewma = 0.9     # 1.9/1, 3.439/1.5, 4.686/2.5
    assert eng._spec_retune() == 4
    eng._accept_ewma = 0.3     # 1.3/1, 1.417/1.5, 1.428/2.5
    assert eng._spec_retune() == 2
    eng.stop()


def test_spec_sampled_replays(lms, draft_off, prompts):
    def sp(i):
        return SamplingParams(temperature=0.8, seed=50 + i)

    kw = dict(max_new=6, sampling_of=sp, draft_model=draft_off[1],
              spec_gamma=2)
    outs1, snap1, _ = _run(GenerationEngine, lms[1], prompts[:2], **kw)
    outs2, _, _ = _run(GenerationEngine, lms[1], prompts[:2], **kw)
    assert outs1 == outs2
    assert snap1["spec"] == "on" and snap1["draft_dispatches"] > 0
    assert snap1["spec_fallbacks"] == 0
    assert all(0 <= t < VOCAB for row in outs1 for t in row)
    # a temperature-0 stream among sampled ones stays greedy
    mixed, _, _ = _run(GenerationEngine, lms[1], prompts[:2],
                       sampling_of=lambda i: SamplingParams(
                           temperature=0.8 * i, seed=9),
                       draft_model=draft_off[1], spec_gamma=3)
    assert mixed[0] == reference_decode(lms[1], prompts[0], 6)


def test_stats_carry_spec_fields(lms, draft_lm, prompts):
    _, snap, eng = _run(GenerationEngine, lms[1], prompts[:1], max_new=4,
                        draft_model=draft_lm[1], spec_gamma=2)
    for key in ("spec", "spec_gamma", "spec_policy",
                "draft_kv_cache_bytes", "draft_dispatches",
                "spec_proposed_tokens", "spec_accepted_tokens",
                "accept_rate", "spec_fallbacks"):
        assert key in snap, key
    assert snap["spec"] == "on" and snap["spec_gamma"] == 2
    assert snap["spec_policy"] == "fixed"
    # the draft's pool is what draft_kv_cache_bytes charges
    alloc = sum(t.numel() * t.element_size()
                for c in eng._draft_caches.values() for t in c.values())
    assert snap["draft_kv_cache_bytes"] == alloc > 0
    assert eng._draft_decoder.num_pages == eng.num_pages
    assert eng._draft_decoder.page_size == eng.page_size
    _, snap0, _ = _run(GenerationEngine, lms[1], prompts[:1], max_new=4)
    assert snap0["spec"] == "off"
    assert snap0["draft_dispatches"] == 0
    assert snap0["draft_kv_cache_bytes"] == 0


def test_spec_config_validation(lms, draft_lm):
    tm, dm = lms[1], draft_lm[1]
    with pytest.raises(ValueError, match=">= 2"):
        GenerationEngine(tm, slots=2, draft_model=dm, spec_gamma=1)
    with pytest.raises(ValueError, match="spec_policy"):
        GenerationEngine(tm, slots=2, draft_model=dm, spec_gamma=2,
                         spec_policy="bogus")
    with pytest.raises(ValueError, match="speculation is off"):
        GenerationEngine(tm, slots=2, draft_model=dm, spec_gamma=0)
    with pytest.raises(ValueError, match="spec_gamma_max"):
        GenerationEngine(tm, slots=2, draft_model=dm, spec_gamma=4,
                         spec_gamma_max=2)
    # the JAX engine raises the same texts
    with pytest.raises(ValueError, match="speculation is off"):
        JaxGenerationEngine(lms[0], slots=2, draft_model=draft_lm[0],
                            spec_gamma=0)
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=0)
    fresh = ft.build_transformer_lm(cfg, device="cpu", **LM)[0]
    with pytest.raises(RuntimeError, match="draft model"):
        GenerationEngine(tm, slots=2, draft_model=fresh, spec_gamma=2)
    other = ft.build_transformer_lm(cfg, device="cpu",
                                    **dict(LM, vocab_size=VOCAB + 1))[0]
    other.compile()
    other.init_layers(seed=0)
    with pytest.raises(ValueError, match="draft vocab"):
        GenerationEngine(tm, slots=2, draft_model=other, spec_gamma=2)
    # LSTM graphs cannot speculate: their state cannot roll back
    lcfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=5)
    lstm = ft.build_lstm_lm(lcfg, vocab_size=VOCAB, embed_dim=24,
                            hidden_dim=24, num_layers=1, seq_len=SEQ,
                            device="cpu")[0]
    lstm.compile()
    lstm.init_layers(seed=5)
    with pytest.raises(ValueError, match="attention"):
        GenerationEngine(lstm, slots=2, draft_model=dm, spec_gamma=2)
    with pytest.raises(ValueError, match="chunkable"):
        GenerationEngine(tm, slots=2, draft_model=lstm, spec_gamma=2)
    # KV migration is ported (tests/test_torch_cluster.py holds it): a
    # stopped speculating engine declines a migrated stream
    eng = GenerationEngine(tm, slots=2, draft_model=dm, spec_gamma=2)
    eng.stop()
    assert eng.adopt_migrated({}) is False
