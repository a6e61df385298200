"""The port's generation bench (``serving/generation/bench.py``) against
the JAX package's, on the CPU at a small size (1-2 layers, d_model 32,
``max_seq`` 32-128), float32.

* The traces of all three serving benches (``make_gen_trace``,
  ``make_prefix_trace``, the disaggregated bench's ``make_flood_trace``
  and ``_victim_prompt``, the fleet bench's ``_requests`` and
  ``_arrivals``) equal the JAX ones bit for bit.
* With the JAX model's weights carried across
  (``interop.params_from_jax_numpy``), ``run_continuous``,
  ``run_static`` and ``reference_decode`` give the JAX token lists, and
  ``run_static``'s counts (groups, decode steps, slot steps, slot
  efficiency) equal the JAX row's; ``_run_prefix_arm`` gives the JAX
  tokens with the prefix cache on and off.
* ``_build_spec_pair`` neutralizes the target as the JAX function does
  (every parameter equal), the draft's parameters are the target's
  tensor objects, and the target's and the draft's greedy tokens equal
  the JAX pair's.
* Each ``run_*_bench`` payload carries the JAX payload's nested keys
  from the same arguments, and its logic booleans are true.

Tokens are compared exactly; float readings (times, rates) are not
compared.
"""

import numpy as np
import pytest

import flexflow_tpu.serving.cluster.bench as jax_cb
import flexflow_tpu.serving.fleet.bench as jax_fb
import flexflow_tpu.serving.generation.bench as jax_gb
from flexflow_tpu.fflogger import silenced as jax_silenced
from flexflow_tpu.serving.generation import \
    GenerationEngine as JaxGenerationEngine
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.fflogger import silenced
from flexflow_tpu_torch.serving.cluster import bench as port_cb
from flexflow_tpu_torch.serving.fleet import bench as port_fb
from flexflow_tpu_torch.serving.generation import bench as port_gb

SLOTS, SEQ = 2, 32
LM = (SLOTS, SEQ, 32, 2, 2, 0)   # slots, max_seq, d_model, heads, layers, seed
STAMP = {"device_kind": "cpu", "calibration_digest": None,
         "comm_plan_digest": ""}


@pytest.fixture(autouse=True)
def _quiet():
    with silenced("ff", "serve"), jax_silenced("ff", "serve"):
        yield
    ft.set_default_device(None)


BUILD_LM = port_gb._build_lm


def _carried(*args):
    """The JAX bench's LM and the port's with the JAX weights."""
    jm = jax_gb._build_lm(*args)
    tm = BUILD_LM(*args, device="cpu")
    interop.params_from_jax_numpy(
        tm, {p.name: jm.get_weights(p.name) for p in jm.parameters})
    return jm, tm


def _carry_build(monkeypatch):
    """Make the port bench's ``_build_lm`` carry the JAX bench's weights
    for the same arguments (the two packages draw initial weights from
    different generators)."""
    def build(slots, max_seq, d_model, num_heads, num_layers, seed,
              device=None):
        return _carried(slots, max_seq, d_model, num_heads, num_layers,
                        seed)[1]
    monkeypatch.setattr(port_gb, "_build_lm", build)
    monkeypatch.setattr(port_cb, "_build_lm", build)


TRACES = {
    "make_gen_trace": lambda m: m.make_gen_trace(24, 2, 8, 4, 96, 0.125, 3),
    "make_prefix_trace": lambda m: m.make_prefix_trace(
        24, 48, 2, 8, 4, 24, 0.25, 5, n_prefixes=3),
    "make_flood_trace": lambda m: m.make_flood_trace(6, 192, 224, 7),
    "_victim_prompt": lambda m: m._victim_prompt(),
    "_requests": lambda m: m._requests(40, 1, 8, 11),
    "_arrivals": lambda m: m._arrivals(40, 123.5, 13),
}
MODULES = {"make_gen_trace": (jax_gb, port_gb),
           "make_prefix_trace": (jax_gb, port_gb),
           "make_flood_trace": (jax_cb, port_cb),
           "_victim_prompt": (jax_cb, port_cb),
           "_requests": (jax_fb, port_fb), "_arrivals": (jax_fb, port_fb)}


def _flat(x):
    if isinstance(x, tuple):
        return [_flat(v) for v in x]
    if isinstance(x, list):
        return [_flat(v) for v in x]
    return x


@pytest.mark.parametrize("name", sorted(TRACES))
def test_traces_equal_the_jax_traces_bit_for_bit(name):
    jax_mod, port_mod = MODULES[name]
    want = _flat(TRACES[name](jax_mod))
    got = _flat(TRACES[name](port_mod))

    def check(g, w):
        if isinstance(w, list):
            assert isinstance(g, list) and len(g) == len(w)
            for a, b in zip(g, w):
                check(a, b)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        else:
            assert type(g) is type(w) and g == w

    check(got, want)


@pytest.fixture(scope="module")
def lms():
    return _carried(*LM)


@pytest.fixture(scope="module")
def trace():
    return port_gb.make_gen_trace(6, 2, 6, 2, 9, 0.34, 0)


def test_continuous_static_and_reference_give_the_jax_tokens(lms, trace):
    jm, tm = lms
    want_c = jax_gb.run_continuous(jm, trace, SLOTS, SEQ, STAMP)[1]
    want_s_row, want_s = jax_gb.run_static(jm, trace, SLOTS, SEQ, STAMP)
    got_c = port_gb.run_continuous(tm, trace, SLOTS, SEQ, STAMP)[1]
    got_s_row, got_s = port_gb.run_static(tm, trace, SLOTS, SEQ, STAMP)
    assert got_c == want_c
    assert got_s == want_s == want_c
    for key in ("groups", "decode_steps", "slot_steps", "slot_efficiency",
                "requests", "tokens"):
        assert got_s_row[key] == want_s_row[key], key
    for prompt, max_new in trace[:2]:
        assert port_gb.reference_decode(tm, prompt, 5, SEQ) == \
            jax_gb.reference_decode(jm, prompt, 5, SEQ)


@pytest.mark.parametrize("cache", ["on", "off"])
def test_prefix_arm_gives_the_jax_tokens(cache):
    jm, tm = _carried(SLOTS, 64, 32, 2, 1, 0)
    trace = port_gb.make_prefix_trace(5, 20, 2, 6, 2, 6, 0.4, 1)
    want_row, want = jax_gb._run_prefix_arm(jm, trace, SLOTS, 64, cache,
                                            STAMP)
    got_row, got = port_gb._run_prefix_arm(tm, trace, SLOTS, 64, cache,
                                           STAMP)
    assert got == want
    assert got_row.keys() == want_row.keys()
    assert got_row["reconciled"] and want_row["reconciled"]
    assert got_row["prefix_hit_tokens"] == want_row["prefix_hit_tokens"]


def _greedy(engine_cls, model, prompts, n):
    eng = engine_cls(model, slots=SLOTS, max_seq=SEQ, stats_every=0)
    with eng:
        return [[int(t) for t in eng.submit(p, max_new_tokens=n)
                 .result(timeout=120)] for p in prompts]


def test_spec_pair_matches_the_jax_pair_and_shares_tensors(monkeypatch):
    _carry_build(monkeypatch)
    args = (SLOTS, SEQ, 32, 2, 3, 0)
    jt, jd = jax_gb._build_spec_pair(*args, draft_layers=1)
    tt, td = port_gb._build_spec_pair(*args, draft_layers=1,
                                      device="cpu")
    for name in jt._params:
        np.testing.assert_array_equal(tt.get_weights(name),
                                      np.asarray(jt.get_weights(name)))
    assert set(td._params) < set(tt._params)
    for name, t in td._params.items():
        assert t is tt._params[name]
        assert t.data_ptr() == tt._params[name].data_ptr()
    prompts = [p for p, _ in port_gb.make_gen_trace(4, 2, 6, 6, 6, 0.0, 2)]
    assert _greedy(ft.GenerationEngine, tt, prompts, 6) == \
        _greedy(JaxGenerationEngine, jt, prompts, 6)
    assert _greedy(ft.GenerationEngine, td, prompts, 6) == \
        _greedy(JaxGenerationEngine, jd, prompts, 6)


def test_spec_pair_refuses_a_draft_as_deep_as_the_target():
    with pytest.raises(ValueError, match="draft layers"):
        port_gb._build_spec_pair(SLOTS, SEQ, 32, 2, 2, 0, draft_layers=2,
                                 device="cpu")


def _assert_keys(port, jax_, path="payload"):
    """Every key of the JAX payload is in the port's, recursively into
    dicts and the rows of lists of dicts."""
    if isinstance(jax_, dict):
        assert isinstance(port, dict), path
        missing = set(jax_) - set(port)
        assert not missing, (path, sorted(missing))
        for k, v in jax_.items():
            _assert_keys(port[k], v, f"{path}.{k}")
    elif isinstance(jax_, list) and jax_ and isinstance(jax_[0], dict):
        assert len(port) == len(jax_), path
        for i, (p, j) in enumerate(zip(port, jax_)):
            _assert_keys(p, j, f"{path}[{i}]")


BENCHES = {
    "generate": ("run_generate_bench", dict(
        requests=6, slots=2, max_seq=32, prompt_lo=2, prompt_hi=6,
        short_new=2, long_new=8, long_frac=0.34, d_model=32, num_heads=2,
        num_layers=1, seed=0, parity_checks=2, mults=(1.0,)),
        ("parity", ("engine_eq_reference", "schedulers_agree"))),
    "prefix": ("run_prefix_bench", dict(
        requests=8, slots=2, max_seq=96, prefix_len=32, d_model=32,
        num_heads=2, num_layers=1, seed=0, prefill_chunk=8,
        stall_prompts=2, stall_prompt_len=40),
        ("acceptance", ("prefix_parity", "hbm_high_water_ok",
                        "reconciliation_ok"))),
    "speculate": ("run_spec_bench", dict(
        requests=2, slots=2, max_seq=32, prompt_lo=2, prompt_hi=6,
        new_tokens=5, d_model=32, num_heads=2, num_layers=2,
        draft_layers=1, seed=0, gamma_max=4, temperature=0.8),
        ("acceptance", ("greedy_parity", "sampled_reproducible"))),
}


@pytest.mark.parametrize("bench", sorted(BENCHES))
def test_bench_payload_has_the_jax_keys_and_logic(bench):
    fn, kw, (section, logic) = BENCHES[bench]
    want = getattr(jax_gb, fn)(**kw)
    got = getattr(port_gb, fn)(**kw, device="cpu")
    _assert_keys(got, want)
    assert got["bench"] == want["bench"]
    assert got["backend"] == "cpu" and got["device_kind"] == "cpu"
    assert got["config"] == want["config"]
    assert all(got[section][k] for k in logic), got[section]
    assert got["comm_plan_digest"] == want["comm_plan_digest"]
