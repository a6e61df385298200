"""The port's token-generation pieces against the JAX package's, on the
CPU, in float32.

Op level (rtol 1e-5, atol 1e-6, at every prefix): ``forward_kv`` against
``forward`` and the JAX op, the dense-cache ``decode``, the paged
``decode_paged`` and chunked ``forward_paged`` against the JAX ops (an
inactive slot's write through the sentinel is dropped on the host by
``kept_writes`` and every page no table names stays bit-unchanged), ``PositionEmbedding.decode`` and
``forward_at`` (pad rows past the table clamp to its last row, where
the JAX gather fills NaN), ``LSTM.forward_states`` and ``decode``.
Sampling: ``filtered_probs`` against the JAX function within 1e-6, and
the Gumbel-max draw's empirical distribution within total variation 0.02
of it over 40,000 draws.  The page pool and prefix trie mirror the JAX
package's unit tests, and the bytes the decoder allocates equal
``kv_cache_bytes`` (and the JAX package's count for the same graph).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.analysis.kv_memory import kv_cache_bytes as jax_kv_bytes
from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.attention import MultiHeadAttention as JaxMHA
from flexflow_tpu.ops.attention import PositionEmbedding as JaxPosEmb
from flexflow_tpu.ops.rnn import LSTM as JaxLSTM
from flexflow_tpu.serving.generation import sampling as jsampling
from flexflow_tpu.tensor import Tensor as JaxTensor
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.analysis.kv_memory import (kv_cache_bytes,
                                                   kv_page_plan)
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops.attention import (MultiHeadAttention,
                                              PositionEmbedding)
from flexflow_tpu_torch.ops.rnn import LSTM
from flexflow_tpu_torch.serving.generation import GraphDecoder, sampling
from flexflow_tpu_torch.serving.generation.decoder import (kept_writes,
                                                          prefill_buckets)
from flexflow_tpu_torch.serving.generation.pages import (KVPagePool,
                                                         PrefixCache)
from flexflow_tpu_torch.tensor import Tensor

RTOL, ATOL = 1e-5, 1e-6
N, S, D, H = 2, 16, 32, 4
PAGE = 4


def _jctx():
    return JaxOpContext(training=False, compute_dtype="float32", mesh=None)


def _ctx():
    return OpContext(compute_dtype="float32")


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _pair(jcls, cls, shape, *args, seed=0, **kw):
    """The same op in both packages with the same random weights."""
    jop = jcls("op", JaxTensor(shape, name="x"), *args, **kw)
    op = cls("op", Tensor(shape, name="x"), *args, **kw)
    rng = np.random.default_rng(seed)
    params = {w.name: (0.1 * rng.standard_normal(w.shape)).astype(np.float32)
              for w in jop.weights}
    assert sorted(params) == sorted(w.name for w in op.weights)
    x = rng.standard_normal(shape).astype(np.float32)
    return (jop, {k: jnp.asarray(v) for k, v in params.items()},
            op, {k: torch.from_numpy(v) for k, v in params.items()}, x)


def _mha_pair(n=N):
    def jcls(name, t, *a, **k):
        return JaxMHA(name, t, t, t, D, H, causal=True)

    def cls(name, t, *a, **k):
        return MultiHeadAttention(name, t, t, t, D, H, causal=True)

    return _pair(jcls, cls, (n, S, D), seed=1)


# ---------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------
def test_forward_kv_is_forward_and_matches_jax():
    jop, jp, op, tp, x = _mha_pair()
    (out,), k, v = op.forward_kv(tp, [torch.from_numpy(x)], _ctx())
    assert torch.equal(out, op.forward(tp, [torch.from_numpy(x)], _ctx())[0])
    (jout,), jk, jv = jop.forward_kv(jp, [jnp.asarray(x)], _jctx())
    for got, want in ((out, jout), (k, jk), (v, jv)):
        _close(got, want)


def test_decode_dense_cache_every_prefix():
    jop, jp, op, tp, x = _mha_pair()
    (full,), k, v = jop.forward_kv(jp, [jnp.asarray(x)], _jctx())
    khost, vhost = np.asarray(k), np.asarray(v)
    for t in range(S):
        kc, vc = np.zeros_like(khost), np.zeros_like(vhost)
        kc[:, :t], vc[:, :t] = khost[:, :t], vhost[:, :t]
        pos = np.full((N,), t, np.int32)
        (jo,), jkc, _ = jop.decode(jp, jnp.asarray(x[:, t:t + 1]),
                                   jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(pos), _jctx())
        tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        (o,), kc2, _ = op.decode(tp, torch.from_numpy(x[:, t:t + 1]), tkc,
                                 tvc, torch.from_numpy(pos), _ctx())
        assert kc2 is tkc                      # updated in place
        _close(o, jo, f"t={t}")
        _close(o[:, 0], np.asarray(full)[:, t], f"t={t} vs forward")
        _close(kc2, jkc, f"t={t} cache")


def _paged_setup(rng, khost, vhost, t, n_pages):
    """Pools of random stale rows, slot i's positions < t scattered into
    the pages of a shuffled table; slot N is inactive (sentinel table)."""
    pps = S // PAGE
    perm = rng.permutation(n_pages)
    table = np.full((N + 1, pps), n_pages, np.int32)
    kp = rng.standard_normal((n_pages, PAGE, H, D // H)).astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    for i in range(N):
        table[i] = perm[i * pps:(i + 1) * pps]
        for p in range(t):
            kp[table[i, p // PAGE], p % PAGE] = khost[i, p]
            vp[table[i, p // PAGE], p % PAGE] = vhost[i, p]
    return table, kp, vp


def test_decode_paged_every_prefix_drops_sentinel_writes():
    jop, jp, op, tp, x = _mha_pair()
    (full,), k, v = jop.forward_kv(jp, [jnp.asarray(x)], _jctx())
    khost, vhost = np.asarray(k), np.asarray(v)
    n_pages = 2 * (S // PAGE) + 3
    rng = np.random.default_rng(2)
    xs = np.concatenate([x, rng.standard_normal((1, S, D)).astype(
        np.float32)])
    for t in range(S):
        table, kp, vp = _paged_setup(rng, khost, vhost, t, n_pages)
        pos = np.array([t, t, 3], np.int32)
        wp = np.array([table[0, t // PAGE], table[1, t // PAGE], n_pages],
                      np.int32)
        wr = np.array([t % PAGE, t % PAGE, 0], np.int32)
        args = (table, pos, wp, wr)
        (jo,), jkp, jvp = jop.decode_paged(
            jp, jnp.asarray(xs[:, t:t + 1]), jnp.asarray(kp),
            jnp.asarray(vp), *map(jnp.asarray, args), _jctx())
        tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        kept = kept_writes(wp, wr, n_pages)
        assert kept[0].tolist() == [0, 1]
        (o,), kp2, vp2 = op.decode_paged(
            tp, torch.from_numpy(xs[:, t:t + 1]), tkp, tvp,
            *(torch.from_numpy(a) for a in (table, pos, *kept)), _ctx())
        assert kp2 is tkp and vp2 is tvp
        _close(o[:N], np.asarray(jo)[:N], f"t={t}")
        _close(o[:N, 0], np.asarray(full)[:, t], f"t={t} vs forward")
        _close(kp2, jkp, f"t={t} pool")
        _close(vp2, jvp, f"t={t} pool")
        # the pages no active table names are bit-unchanged
        named = set(table[:N].reshape(-1).tolist())
        for pg in set(range(n_pages)) - named:
            assert torch.equal(kp2[pg], torch.from_numpy(kp[pg]))
            assert torch.equal(vp2[pg], torch.from_numpy(vp[pg]))


def test_decode_paged_all_sentinel_writes_nothing():
    jop, jp, op, tp, x = _mha_pair()
    rng = np.random.default_rng(3)
    kp = torch.from_numpy(rng.standard_normal((5, PAGE, H, D // H)).astype(
        np.float32))
    vp = kp.clone() + 1
    k0, v0 = kp.clone(), vp.clone()
    table = torch.full((N, S // PAGE), 5, dtype=torch.int32)
    kept = kept_writes(np.full((N,), 5, np.int32),
                       np.array([0, 3], np.int32), 5)
    assert all(a.size == 0 for a in kept)
    op.decode_paged(tp, torch.from_numpy(x[:, :1]), kp, vp, table,
                    torch.zeros(N, dtype=torch.int32),
                    *(torch.from_numpy(a) for a in kept), _ctx())
    assert torch.equal(kp, k0) and torch.equal(vp, v0)


@pytest.mark.parametrize("chunk", [3, 5, S])
def test_forward_paged_chunks_match_jax_and_forward(chunk):
    jop, jp, op, tp, x = _mha_pair(n=1)
    full = np.asarray(jop.forward(jp, [jnp.asarray(x)], _jctx())[0])
    n_pages = S // PAGE + 2
    rng = np.random.default_rng(4)
    table = rng.permutation(n_pages)[:S // PAGE].astype(np.int32)
    kp = rng.standard_normal((n_pages, PAGE, H, D // H)).astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for start in range(0, S, chunk):
        length = min(chunk, S - start)
        bucket = next(b for b in prefill_buckets(S) if b >= length)
        xb = np.zeros((1, bucket, D), np.float32)
        xb[0, :length] = x[0, start:start + length]
        (jo,), jkp, jvp = jop.forward_paged(
            jp, jnp.asarray(xb), jkp, jvp, jnp.asarray(table),
            jnp.int32(start), jnp.int32(length), _jctx())
        (o,), _, _ = op.forward_paged(tp, torch.from_numpy(xb), tkp, tvp,
                                      torch.from_numpy(table), start,
                                      length, _ctx())
        _close(o[0, :length], np.asarray(jo)[0, :length], f"at {start}")
        _close(o[0, :length], full[0, start:start + length],
               f"at {start} vs forward")
    _close(tkp, jkp)
    _close(tvp, jvp)
    for pg in set(range(n_pages)) - set(table.tolist()):
        assert torch.equal(tkp[pg], torch.from_numpy(kp[pg]))


def test_position_embedding_decode_and_forward_at():
    jop, jp, op, tp, x = _pair(JaxPosEmb, PositionEmbedding, (N, S, D),
                               seed=5)
    full = op.forward(tp, [torch.from_numpy(x)], _ctx())[0]
    _close(full, jop.forward(jp, [jnp.asarray(x)], _jctx())[0])
    for t in range(S):
        pos = np.full((N,), t, np.int32)
        got = op.decode(tp, torch.from_numpy(x[:, t:t + 1]),
                        torch.from_numpy(pos), _ctx())[0]
        want = jop.decode(jp, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos),
                          _jctx())[0]
        _close(got, want, f"t={t}")
        assert torch.equal(got[:, 0], full[:, t])
    # a bucket of 8 at offset 12 runs 4 rows past the 16-row table
    xb = np.random.default_rng(6).standard_normal((1, 8, D)).astype(
        np.float32)
    got = op.forward_at(tp, torch.from_numpy(xb), 12, _ctx())[0][0]
    want = np.asarray(jop.forward_at(jp, jnp.asarray(xb), jnp.int32(12),
                                     _jctx())[0][0])
    _close(got[:4], want[:4])
    table = tp[op.w_table.name]
    assert torch.equal(got[4:], torch.from_numpy(xb[0, 4:]) + table[-1])
    assert torch.isfinite(got).all()


def test_lstm_forward_states_and_decode():
    jop, jp, op, tp, x = _pair(JaxLSTM, LSTM, (N, S, 24), 8, seed=7)
    outs, hs, cs = op.forward_states(tp, [torch.from_numpy(x)], _ctx())
    jouts, jhs, jcs = jop.forward_states(jp, [jnp.asarray(x)], _jctx())
    for got, want in zip(outs, jouts):
        _close(got, want)
    _close(hs, jhs)
    _close(torch.stack(cs, dim=1), jcs)
    fseq = op.forward(tp, [torch.from_numpy(x)], _ctx())[0]
    assert torch.equal(fseq, outs[0])
    h = torch.zeros((N, 8))
    c = torch.zeros((N, 8))
    jh, jc = jnp.zeros((N, 8)), jnp.zeros((N, 8))
    for t in range(S):
        (o, _, _), h, c = op.decode(tp, torch.from_numpy(x[:, t:t + 1]), h,
                                    c, _ctx())
        (jo, _, _), jh, jc = jop.decode(jp, jnp.asarray(x[:, t:t + 1]), jh,
                                        jc, _jctx())
        _close(o, jo, f"t={t}")
        _close(o[:, 0], fseq[:, t], f"t={t} vs forward")
    # seeded from the prefill's mid-sequence carry
    for t0 in (5, 11):
        (o, _, _), _, _ = op.decode(tp, torch.from_numpy(x[:, t0:t0 + 1]),
                                    hs[:, t0 - 1], cs[t0 - 1], _ctx())
        _close(o[:, 0], fseq[:, t0])


# ---------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------
def _strategies():
    temp = np.array([0.0, 0.8, 1.0, 1.5, 0.7, 0.0, 1.2, 0.9], np.float32)
    top_k = np.array([0, 8, 0, 3, 1, 5, 61, 12], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.3, 0.8, 0.95, 1.0], np.float32)
    return temp, top_k, top_p


def test_filtered_probs_matches_jax():
    rng = np.random.default_rng(8)
    logits = (2 * rng.standard_normal((8, 61))).astype(np.float32)
    logits[2, 10:14] = logits[2].max() + 0.5   # ties at the top-p cut
    temp, top_k, top_p = _strategies()
    want = jsampling.filtered_probs(jnp.asarray(logits), jnp.asarray(temp),
                                    jnp.asarray(top_k), jnp.asarray(top_p))
    got = sampling.filtered_probs(torch.from_numpy(logits),
                                  torch.from_numpy(temp),
                                  torch.from_numpy(top_k),
                                  torch.from_numpy(top_p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert (got.numpy()[temp <= 0].max(axis=1) == 1.0).all()
    assert ((got.numpy() > 0) == (np.asarray(want) > 0)).all()


def test_gumbel_draws_follow_filtered_probs():
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.standard_normal((1, 61)).astype(
        np.float32))
    p = sampling.filtered_probs(logits, torch.tensor([0.8]),
                                torch.tensor([8]), torch.tensor([0.95]))[0]
    n = 40_000
    draws = sampling.categorical(p.expand(n, -1), torch.full((n,), 11),
                                 torch.arange(n))
    freq = np.bincount(draws.numpy(), minlength=61) / n
    assert (freq[p.numpy() == 0] == 0).all()
    tv = 0.5 * np.abs(freq - p.numpy()).sum()
    assert tv <= 0.02, tv
    # a fixed function of (seed, position, stream, index)
    again = sampling.categorical(p.expand(64, -1), torch.full((64,), 11),
                                 torch.arange(64))
    assert torch.equal(again, draws[:64])
    other = sampling.categorical(p.expand(64, -1), torch.full((64,), 12),
                                 torch.arange(64))
    assert not torch.equal(other, draws[:64])


def test_uniforms_are_open_interval_and_distinct():
    u = sampling.uniform_01(torch.tensor([0, -5, 2**31 - 1]),
                            torch.tensor([0, 1, 2**20]), 0, 50257)
    assert u.dtype == torch.float64 and u.shape == (3, 50257)
    assert (u > 0).all() and (u < 1).all()
    assert all(torch.unique(row).numel() == 50257 for row in u)
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_sampling_params_validation():
    with pytest.raises(ValueError, match="temperature"):
        sampling.SamplingParams(temperature=-1.0)
    with pytest.raises(ValueError, match="top_k"):
        sampling.SamplingParams(top_k=-1)
    with pytest.raises(ValueError, match="top_p"):
        sampling.SamplingParams(top_p=0.0)
    assert sampling.GREEDY.is_greedy
    assert not sampling.SamplingParams(temperature=0.5).is_greedy


# ---------------------------------------------------------------------
# page pool and prefix trie
# ---------------------------------------------------------------------
def test_page_pool_refcounts_and_high_water():
    pool = KVPagePool(4, page_size=16)
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {0, 1} and pool.pages_in_use == 2
    assert pool.high_water == 2 and pool.no_page == 4
    pool.ref(a)
    assert not pool.release(a)
    assert pool.release(a)
    assert pool.pages_in_use == 1
    c, d, e = pool.alloc(), pool.alloc(), pool.alloc()
    assert pool.alloc() is None
    assert pool.high_water == 4
    assert {c, d, e} | {b} == {0, 1, 2, 3}
    with pytest.raises(ValueError):
        KVPagePool(0)


def test_prefix_trie_lookup_insert_evict():
    pool = KVPagePool(8, page_size=4)
    trie = PrefixCache(pool)
    toks = np.arange(100, 112, dtype=np.int32)
    assert trie._pages_of(toks, 4) == [(100, 101, 102, 103),
                                       (104, 105, 106, 107)]
    p0, p1 = pool.alloc(), pool.alloc()
    assert trie.insert(toks, [p0, p1]) == 2
    assert pool.refcount(p0) == 2
    ext = np.concatenate([toks, np.array([7, 8], np.int32)])
    hits = trie.lookup(ext)
    assert hits == [p0, p1] and pool.refcount(p0) == 3
    div = toks.copy()
    div[5] = 99
    assert trie.lookup(div) == [p0]
    for pg in (p0, p0, p0, p1, p1):
        pool.release(pg)
    assert pool.refcount(p0) == 1 and pool.refcount(p1) == 1
    assert trie.evict_one() and pool.refcount(p1) == 0
    assert trie.evict_one() and pool.refcount(p0) == 0
    assert not trie.evict_one() and len(trie) == 0
    assert trie.evictions == 2
    assert trie.hits == 2 and trie.misses == 0


def test_prefix_trie_clear_releases_every_page():
    pool = KVPagePool(6, page_size=2)
    trie = PrefixCache(pool)
    toks = np.arange(7, dtype=np.int32)
    pages = [pool.alloc() for _ in range(3)]
    trie.insert(toks, pages)
    for pg in pages:
        pool.release(pg)
    assert pool.pages_in_use == 3
    trie.clear()
    assert pool.pages_in_use == 0 and len(trie) == 0


# ---------------------------------------------------------------------
# KV bytes: allocated == accounted == the JAX package's count
# ---------------------------------------------------------------------
def _port_lm(kind, compute_dtype):
    cfg = ft.FFConfig(batch_size=4, compute_dtype=compute_dtype)
    if kind == "transformer":
        model, _, logits = ft.build_transformer_lm(
            cfg, num_layers=2, d_model=32, num_heads=2, d_ff=64, seq_len=32,
            vocab_size=61, device="cpu")
    else:
        model, _, logits = ft.build_lstm_lm(
            cfg, vocab_size=61, embed_dim=24, hidden_dim=24, num_layers=2,
            seq_len=32, device="cpu")
    model.compile(final_tensor=logits)
    return model


def _jax_lm(kind):
    import flexflow_tpu as ff
    from flexflow_tpu.models import build_lstm_lm, build_transformer_lm
    cfg = ff.FFConfig(batch_size=4, compute_dtype="float32")
    if kind == "transformer":
        return build_transformer_lm(cfg, num_layers=2, d_model=32,
                                    num_heads=2, d_ff=64, seq_len=32,
                                    vocab_size=61)[0]
    return build_lstm_lm(cfg, vocab_size=61, embed_dim=24, hidden_dim=24,
                         num_layers=2, seq_len=32)[0]


@pytest.mark.parametrize("kind", ["transformer", "lstm"])
@pytest.mark.parametrize("compute_dtype,nbytes",
                         [("float32", 4), ("bfloat16", 2)])
@pytest.mark.parametrize("slots,num_pages", [(2, 0), (3, 9)])
def test_kv_cache_bytes_equal_the_allocation(kind, compute_dtype, nbytes,
                                             slots, num_pages):
    model = _port_lm(kind, compute_dtype)
    dec = GraphDecoder(model, slots, 32, page_size=PAGE,
                       num_pages=num_pages)
    caches = dec.init_cache()
    real = sum(t.numel() * t.element_size() for sub in caches.values()
               for t in sub.values())
    want = kv_cache_bytes(model.layers, None, slots, 32,
                          kv_dtype_bytes=nbytes, page_size=PAGE,
                          num_pages=num_pages)
    assert real == want > 0
    assert all(not t.any() for sub in caches.values()
               for t in sub.values())            # zeroed, never empty
    jax_model = _jax_lm(kind)
    assert want == jax_kv_bytes(jax_model.layers, {"n": 1}, slots, 32,
                                kv_dtype_bytes=nbytes, page_size=PAGE,
                                num_pages=num_pages)
    plan = kv_page_plan(model.layers, None, slots, 32,
                        kv_dtype_bytes=nbytes, page_size=PAGE,
                        num_pages=num_pages)
    assert plan["pool_bytes"] + plan["state_bytes"] == plan["total_bytes"]
    assert plan["num_pages"] == dec.num_pages


def test_kv_bytes_feed_the_memory_gate():
    from flexflow_tpu_torch.analysis.strategy_passes import \
        memory_diagnostics
    import dataclasses
    from flexflow_tpu_torch.search.cost_model import spec_for_device
    model = _port_lm("transformer", "float32")
    spec = dataclasses.replace(spec_for_device(), hbm_capacity=2e9)
    kv = kv_cache_bytes(model.layers, None, 4096, 32, kv_dtype_bytes=4)
    base = memory_diagnostics(model.layers, {}, {"n": 1}, 1, spec=spec)
    over = memory_diagnostics(model.layers, {}, {"n": 1}, 1, spec=spec,
                              extra_state_bytes=50 * kv)
    assert "FF108" not in {d.code for d in base}
    ff108 = [d for d in over if d.code == "FF108"]
    assert ff108 and "KV cache" in ff108[0].message


def test_prefill_buckets():
    assert prefill_buckets(32) == (2, 4, 8, 16, 32)
    assert prefill_buckets(1024)[-1] == 1024
    assert prefill_buckets(24) == (2, 4, 8, 16, 24)
    assert math.log2(prefill_buckets(1024)[-2]) == 9
