"""The ``explain`` report in the port (``analysis/sharding_passes.py``:
``explain_report``, ``render_explain_text``, ``validate_explain_json``)
against the JAX package's, on the CPU.

The same graph and strategy in both packages give the same payload —
propagation, predicted fallbacks, communication plan and digest, the
liveness memory timeline and, for a generation deployment, the KV-cache
section — and the same text, under the reference spec (the JAX
package's DeviceSpec values, ``_torch_search_cases.reference_spec``).
"""

import copy

import pytest

import _torch_search_cases as cases
import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.analysis import explain_report as jax_explain
from flexflow_tpu.analysis import render_explain_text as jax_render
from flexflow_tpu.analysis import validate_explain_json as jax_validate
from flexflow_tpu_torch.analysis import (explain_report, render_explain_text,
                                         validate_explain_json)


def _lm(pkg):
    from flexflow_tpu.models import build_transformer_lm as jax_fn
    cfg = pkg.FFConfig(batch_size=4, compute_dtype="float32")
    fn = jax_fn if pkg is ff else ft.build_transformer_lm
    return fn(cfg, num_layers=2, d_model=32, num_heads=2, d_ff=64,
              seq_len=16, vocab_size=64, **cases.DEV[pkg])[0]


def _pair(name):
    if name == "lm":
        return _lm(ff), _lm(ft)
    return cases.pair(name)


def _both(jm, pm, jstrat, **kw):
    """The JAX package's report and the port's for one (graph, strategy):
    ``jstrat`` is the JAX package's {name: ParallelConfig}."""
    pstrat = {k: cases.port_pc(v) for k, v in jstrat.items()}
    want = jax_explain("m", jm.layers, jstrat, **kw)
    got = explain_report("m", pm.layers, pstrat, spec=cases.REF, **kw)
    return got, want


CASES = [
    ("transformer", 64, 0, dict(mesh_shape={"n": 16, "c": 4},
                                num_devices=64)),
    ("transformer", 8, 1, {}),
    ("dlrm", 4, 2, dict(dtype_bytes=4, sparse_tables=frozenset(
        {"embedding/table"}), opt_slot_bytes=8)),
    ("alexnet", 8, 3, {}),
    ("inception", 4, 4, dict(num_devices=4)),
    ("moe", 4, 5, {}),
    ("lm", 2, 6, dict(dtype_bytes=4, serve_slots=8, serve_seq=16)),
    ("lm", 1, 7, dict(mesh_shape={"n": 1}, serve_slots=4, serve_seq=16,
                      serve_kv_page=4, serve_kv_pages=40)),
]


@pytest.mark.parametrize("name,ndev,seed,kw", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_report_and_text_equal_the_jax_package(name, ndev, seed, kw):
    jm, pm = _pair(name)
    jstrat, mesh = cases.random_strategies(jm.layers, ndev, seed)
    if "mesh_shape" not in kw and seed % 2:
        kw = dict(kw, mesh_shape={a: s for a, s in mesh.items() if s > 1})
    got, want = _both(jm, pm, jstrat, **kw)
    assert got == want
    assert validate_explain_json(got) == jax_validate(want) == []
    assert render_explain_text(got) == jax_render(want)
    assert render_explain_text(got, top=2) == jax_render(want, top=2)
    if kw.get("serve_slots"):
        plain, _ = _both(jm, pm, jstrat, **{
            k: v for k, v in kw.items() if not k.startswith("serve")})
        kv = got["kv_cache"]["bytes_per_device"]
        assert kv > 0
        assert got["memory_timeline"]["state_bytes"] == pytest.approx(
            plain["memory_timeline"]["state_bytes"] + kv)


def test_default_strategy_and_small_machine_notes():
    jm, pm = cases.pair("transformer")
    for kw in (dict(mesh_shape={"n": 64}, num_devices=8),
               dict(mesh_shape={"n": 64}), {}):
        got, want = _both(jm, pm, {}, **kw)
        assert got == want
        assert render_explain_text(got) == jax_render(want)
    got, _ = _both(jm, pm, {}, mesh_shape={"n": 64}, num_devices=8)
    assert got["num_devices"] == 64 and "FF112" in got["notes"][0]
    assert "NOTE:" in render_explain_text(got)
    assert explain_report("m", pm.layers, None, spec=cases.REF) == \
        jax_explain("m", jm.layers, None)
    # the port's default spec is the card's
    rep = explain_report("m", pm.layers, {})
    assert rep["memory_timeline"]["hbm_capacity_bytes"] == 80e9


def _corruptions(rep):
    out = [[], 3, {}, dict(rep, report="lint")]
    for key, val in (("model", 1), ("mesh", []), ("num_devices", "4"),
                     ("ops", None), ("predicted_fallbacks", {}),
                     ("comm_plan", []), ("comm_plan_digest", 7),
                     ("memory_timeline", 0), ("notes", "x")):
        out.append(dict(rep, **{key: val}))
    bad = copy.deepcopy(rep)
    bad["predicted_fallbacks"] = [{"op": 1}, "x"]
    out.append(bad)
    bad = copy.deepcopy(rep)
    bad["comm_plan"]["edges"] = [{"kind": "teleport", "bytes_per_step": 1},
                                 {"kind": "reshard", "bytes_per_step": 1.5}]
    bad["comm_plan"]["weight_sync"] = [{"kind": "allreduce",
                                        "bytes_per_step": 1}]
    bad["comm_plan"]["totals"] = None
    out.append(bad)
    bad = copy.deepcopy(rep)
    bad["comm_plan_digest"] = "0" * 16
    out.append(bad)
    bad = copy.deepcopy(rep)
    bad["comm_plan"] = {"edges": None}
    out.append(bad)
    bad = copy.deepcopy(rep)
    bad["memory_timeline"] = {"state_bytes": "1", "peak_owners": {}}
    out.append(bad)
    return out


def test_validation_errors_equal_the_jax_package():
    jm, pm = cases.pair("dlrm")
    jstrat, _ = cases.random_strategies(jm.layers, 4, 0)
    got, want = _both(jm, pm, jstrat)
    for p, j in zip(_corruptions(got), _corruptions(want)):
        errs = validate_explain_json(p)
        assert errs == jax_validate(j)
        if p is not got:
            assert errs, p
