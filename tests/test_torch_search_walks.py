"""The strategy search in the port (``search/mcmc.py``, ``decompose.py``,
``hybrid.py``, ``calibration.py``) against the JAX package's, on the CPU.

Under the reference spec (the JAX package's DeviceSpec values,
``_torch_search_cases.reference_spec``) the port's fixed-seed walks are
the JAX package's: the golden ``search(mlp, 8, budget=80, seed=0)``
(digest ``d584a363574e0539``, mesh ``{"c": 8}``, 0.01351351 ms, as
``tests/test_search_hybrid.py`` pins it), and the MLP, branchy, diamond,
small-transformer and DLRM graphs at seeds 0-2, one and two chains, with
the precision axis, a fixed mesh, ``mode="hybrid"`` and a warm start —
the same strategies, mesh, simulated time and walk statistics.  The
decomposition's regions, the exact DP's solutions and the graph digests
are equal; a best-strategy store and a strategy file written by either
package load in the other; ``compile(search_budget)`` on one process
searches as the JAX package's ``optimize_strategies`` does, a
calibration setting that does not resolve raises the JAX package's
ValueError, and ``trace_dir`` is refused naming A.11.
"""

import json
import os

import pytest

import _torch_search_cases as cases
import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.search import decompose as jax_dec
from flexflow_tpu.search import mcmc as jax_mcmc
from flexflow_tpu.search.hybrid import BestStrategyStore as JaxStore
from flexflow_tpu.strategy import proto as jax_proto
from flexflow_tpu_torch.search import decompose as port_dec
from flexflow_tpu_torch.search import mcmc as port_mcmc
from flexflow_tpu_torch.search.hybrid import BestStrategyStore as PortStore
from flexflow_tpu_torch.search.hybrid import validate_store
from flexflow_tpu_torch.search.simulator import Simulator as PortSim
from flexflow_tpu_torch.strategy import proto as port_proto

GOLDEN_DIGEST = "d584a363574e0539"
GOLDEN_MESH = {"c": 8}
GOLDEN_MS = 0.01351351


def walk(pkg, layers, ndev, **kw):
    """One search in either package; returns (strategy digest, mesh
    axes > 1, time, stats without wall clocks) — the digest is each
    package's own ``strategy_digest`` of its own configs."""
    st = {}
    if pkg is ff:
        best, mesh, t = jax_mcmc.search(layers, ndev, stats=st,
                                        flash_attention=False, **kw)
        digest = jax_proto.strategy_digest(best)
    else:
        best, mesh, t = port_mcmc.search(layers, ndev, stats=st,
                                         spec=cases.REF, device="cpu",
                                         flash_attention=False, **kw)
        digest = port_proto.strategy_digest(best)
    st.pop("time_to_best_ms", None)
    return digest, {a: s for a, s in mesh.items() if s > 1}, t, st


def test_golden_walk():
    m = cases.mlp(ft)
    for chains in (1, 4):
        best, mesh, t = port_mcmc.search(m.layers, 8, budget=80, seed=0,
                                         chains=chains, spec=cases.REF,
                                         device="cpu")
        assert port_proto.strategy_digest(best) == GOLDEN_DIGEST
        assert {a: s for a, s in mesh.items() if s > 1} == GOLDEN_MESH
        assert t * 1e3 == pytest.approx(GOLDEN_MS, rel=1e-5)


WALKS = [
    ("mlp", 8, dict(budget=80)),
    ("branchy", 8, dict(budget=60)),
    ("diamond", 4, dict(budget=60)),
    ("transformer", 8, dict(budget=60)),
    ("dlrm", 4, dict(budget=60)),
]


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,ndev,kw", WALKS, ids=[w[0] for w in WALKS])
def test_walks_equal_the_jax_package(name, ndev, kw, seed, chains):
    jm, pm = cases.pair(name)
    got = walk(ft, pm.layers, ndev, seed=seed, chains=chains, **kw)
    want = walk(ff, jm.layers, ndev, seed=seed, chains=chains, **kw)
    assert got == want


@pytest.mark.parametrize("variant", [
    dict(precision_axis=True),
    dict(fixed_mesh={"n": 2, "c": 2}),
    dict(mode="hybrid"),
    dict(mode="hybrid", chains=2, precision_axis=True),
    dict(overlap_backward_update=True, devices_per_slice=2),
    dict(alpha=0.5, remat=True),
], ids=["precision", "fixed_mesh", "hybrid", "hybrid_chains_precision",
        "overlap_slices", "alpha_remat"])
@pytest.mark.parametrize("name", ["branchy", "transformer", "dlrm"])
def test_walk_options_equal_the_jax_package(name, variant):
    jm, pm = cases.pair(name)
    got = walk(ft, pm.layers, 4, budget=50, seed=1, **variant)
    want = walk(ff, jm.layers, 4, budget=50, seed=1, **variant)
    assert got == want


def test_hybrid_warm_start_and_stores_cross_load(tmp_path):
    """The hybrid search seeds from and updates a best-strategy store:
    each package's store after the same search holds the same entry
    bytes, each loads the other's, and a warm-started second search is
    the JAX package's."""
    jm, pm = cases.pair("branchy")
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    for _ in range(2):   # the first run writes, the second warm-starts
        want = walk(ff, jm.layers, 4, budget=40, seed=0, mode="hybrid",
                    warm_start=jpath)
        got = walk(ft, pm.layers, 4, budget=40, seed=0, mode="hybrid",
                   warm_start=ppath)
        assert got == want
    with open(jpath) as f:
        jdata = json.load(f)
    with open(ppath) as f:
        pdata = json.load(f)
    assert pdata == jdata and not validate_store(jdata)
    key = next(iter(jdata["entries"]))
    assert key.startswith(port_dec.graph_digest(pm.layers))
    ps, pmesh, pt = PortStore.load(jpath).get(key)
    js, jmesh, jt = JaxStore.load(ppath).get(key)
    assert port_proto.strategy_digest(ps) == jax_proto.strategy_digest(js)
    assert (pmesh, pt) == (jmesh, jt)
    # a tampered store is refused by both
    jdata["entries"][key]["time_ms"] = 0.0
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump(jdata, f)
    with pytest.raises(ValueError, match="digest mismatch"):
        PortStore.load(bad)


def test_searched_strategy_files_cross_load(tmp_path):
    jm, pm = cases.pair("transformer")
    best, _, _ = port_mcmc.search(pm.layers, 8, budget=60, seed=2,
                                  spec=cases.REF, device="cpu",
                                  flash_attention=False)
    path = str(tmp_path / "port.pb")
    port_proto.save_strategy_file(path, best)
    loaded = jax_proto.load_strategy_file(path)
    assert jax_proto.strategy_digest(loaded) == \
        port_proto.strategy_digest(best)
    jbest, _, _ = jax_mcmc.search(jm.layers, 8, budget=60, seed=2,
                                  flash_attention=False)
    jpath = str(tmp_path / "jax.pb")
    jax_proto.save_strategy_file(jpath, jbest)
    assert port_proto.strategy_digest(
        port_proto.load_strategy_file(jpath)) == \
        jax_proto.strategy_digest(jbest)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", sorted(cases.ZOO) + ["branchy", "diamond"])
def test_decompose_and_graph_digest_equal_the_jax_package(name):
    jm, pm = cases.pair(name)
    jr, jres = jax_dec.decompose(jm.layers)
    pr, pres = port_dec.decompose(pm.layers)

    def rows(regions):
        return [(r.kind, r.ops, r.fork, r.join, r.branches) for r in regions]

    assert rows(pr) == rows(jr) and pres == jres
    assert port_dec.graph_digest(pm.layers) == \
        jax_dec.graph_digest(jm.layers)
    assert port_dec.build_dag(pm.layers) == jax_dec.build_dag(jm.layers)


@pytest.mark.parametrize("name,mesh", [
    ("mlp", {"n": 2, "c": 4}), ("diamond", {"n": 2, "c": 2}),
    ("transformer", {"n": 2, "c": 2})])
def test_exact_solvers_equal_the_jax_package(name, mesh):
    from flexflow_tpu.search.simulator import Simulator as JaxSim
    jm, pm = cases.pair(name)
    ndev = 1
    for v in mesh.values():
        ndev *= v
    full = {a: mesh.get(a, 1) for a in ("n", "c", "h", "w", "s", "e", "p")}
    jsim = JaxSim(num_devices=ndev, use_native=False, flash_attention=False)
    psim = PortSim(spec=cases.REF, num_devices=ndev, use_native=False,
                   flash_attention=False, device="cpu")
    jc = {op.name: jax_mcmc.legal_configs(op, full) for op in jm.layers}
    pc = {op.name: port_mcmc.legal_configs(op, full) for op in pm.layers}
    jr, _ = jax_dec.decompose(jm.layers)
    pr, _ = port_dec.decompose(pm.layers)
    jf, jidx, jt = jax_dec.solve_regions(jsim, jm.layers, jr, jc)
    pf, pidx, pt = port_dec.solve_regions(psim, pm.layers, pr, pc)
    assert (pidx, pt) == (jidx, jt)
    assert {k: (v.dims, v.device_ids) for k, v in pf.items()} == \
        {k: (v.dims, v.device_ids) for k, v in jf.items()}
    if name == "mlp":
        chain = pm.layers
        dp, t = port_dec.solve_chain(psim, chain, pc)
        ex, te = port_dec.solve_chain_exhaustive(psim, chain, pc)
        assert t == pytest.approx(te, rel=1e-12)
    dps = port_dec.data_parallel_strategies(pm.layers, ndev)
    jdp = jax_dec.data_parallel_strategies(jm.layers, ndev)
    assert {k: v.dims for k, v in dps.items()} == \
        {k: v.dims for k, v in jdp.items()}


def _compiled(pkg, **cfg_kw):
    from flexflow_tpu.models import build_transformer as jax_fn
    cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32",
                       flash_attention=False, **cfg_kw)
    fn = jax_fn if pkg is ff else ft.build_transformer
    m, _, logits = fn(cfg, num_layers=2, d_model=32, num_heads=2, d_ff=64,
                      seq_len=16, vocab_size=128, num_classes=4,
                      **cases.DEV[pkg])
    return m, logits


def test_compile_searches_on_one_process(tmp_path, capsys):
    """One process is one device: compile's search covers that device,
    the JAX package's optimize_strategies for one device gives the same
    strategies, the searched mesh is pinned and the file exported."""
    out = str(tmp_path / "searched.pb")
    m, logits = _compiled(ft, search_budget=20, export_strategy_file=out)
    m.compile(ft.AdamOptimizer(alpha=1e-3), final_tensor=logits)
    assert "[search] best simulated iteration time" in capsys.readouterr().out
    assert m.config.mesh_shape == {}
    jm, jlogits = _compiled(ff, search_budget=20)
    jm.optimizer = ff.AdamOptimizer(alpha=1e-3)
    want = jax_mcmc.optimize_strategies(jm, jm.config, num_devices=1)
    got = port_proto.load_strategy_file(out)
    assert port_proto.strategy_digest(got) == \
        jax_proto.strategy_digest(want)
    assert {op.name: op.parallel_config.dims for op in m.layers} == \
        {k: v.dims for k, v in want.items()}


@pytest.mark.parametrize("field,value,exc,item", [
    ("calibration_file", "table.json", ValueError,
     "cannot load calibration table"),
    ("cost_estimator", "ridge", ValueError, "needs a calibration table"),
    ("trace_dir", "traces", NotImplementedError, "A.11")])
def test_unported_settings_name_their_roadmap_item(field, value, exc, item):
    """``trace_dir`` is refused naming A.11; a calibration setting that
    does not resolve raises the JAX package's ValueError (the calibrated
    search itself: ``tests/test_torch_calibration.py``)."""
    m, logits = _compiled(ft, search_budget=5, **{field: value})
    with pytest.raises(exc, match=item.replace(".", r"\.")):
        m.compile(ft.AdamOptimizer(alpha=1e-3), final_tensor=logits)


def test_estimator_from_config_uncalibrated_branch():
    from flexflow_tpu_torch.search.calibration import (content_digest,
                                                       estimator_from_config)
    from flexflow_tpu.search.calibration import content_digest as jax_cd
    for est in ("auto", "analytic"):
        cfg = ft.FFConfig(cost_estimator=est)
        assert estimator_from_config(cfg) == (None, None)
    for kw, msg in ((dict(cost_estimator="table"),
                     "needs a calibration table"),
                    (dict(calibration_file="x.json"),
                     "cannot load calibration table"),
                    (dict(calibration_file="x.json",
                          cost_estimator="analytic"),
                     "cannot load calibration table")):
        with pytest.raises(ValueError, match=msg):
            estimator_from_config(ft.FFConfig(**kw))
    payload = {"kind": "k", "version": 1, "entries": {"a": {"b": [1, 2.5]}},
               "digest": "ignored"}
    assert content_digest(payload) == jax_cd(payload)


def test_search_refuses_unknown_mode_and_bad_fixed_mesh():
    m = cases.mlp(ft)
    with pytest.raises(ValueError, match="unknown search mode"):
        port_mcmc.search(m.layers, 8, budget=4, mode="exhaustive",
                         device="cpu")
    with pytest.raises(ValueError, match="fixed_mesh"):
        port_mcmc.search(m.layers, 8, budget=4, fixed_mesh={"n": 2},
                         device="cpu")
    assert os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
