"""The strategy search on four gloo CPU ranks
(``tests/_torch_search_worker.py``) against the JAX package, which
searches and trains the same graph on four of its virtual devices.

``compile(search_budget=40)`` on every rank (the analytic objective,
deterministic, so each rank searches) gives the strategies and mesh the
JAX package's compile gives for four devices under the same device spec;
every rank exports the same strategy file; the searched strategy trains
2 steps within rtol 1e-4, atol 1e-5 (the mesh tests' tolerance) of the
JAX package's losses; ``reshard(new_mesh={"n": 4}, research=True)``
re-searches pinned to that mesh and picks the JAX reshard's
strategies, and every rank takes the same step after it.  In measure
mode rank 0 alone times the candidates and broadcasts its result: every
rank compiles the same strategies.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

import _torch_mesh_cases as mesh_cases
import _torch_search_cases as cases
import flexflow_tpu as ff
from flexflow_tpu.models import build_transformer as jax_transformer
from flexflow_tpu.parallel.mesh import MachineMesh as JaxMesh
from flexflow_tpu.strategy.proto import strategy_digest

RTOL, ATOL = 1e-4, 1e-5
ARCH = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, seq_len=16,
            vocab_size=128, num_classes=4)


def _jax_model(**cfg_kw):
    cfg = ff.FFConfig(batch_size=8, compute_dtype="float32",
                      flash_attention=False, workers_per_node=4, **cfg_kw)
    m, _, logits = jax_transformer(cfg, **ARCH)
    m.compile(ff.AdamOptimizer(alpha=1e-3), final_tensor=logits)
    m.init_layers(seed=0)
    return m


def _weights(m):
    return {p.name: np.asarray(m.get_weights(p.name), np.float32)
            for p in m.parameters}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("search_mesh"))
    with open(os.path.join(wd, "spec.json"), "w") as f:
        json.dump(dataclasses.asdict(cases.REF), f)
    jm = _jax_model(search_budget=40, seed=3)
    rng = np.random.default_rng(0)
    x = rng.integers(0, ARCH["vocab_size"], (8, ARCH["seq_len"])
                     ).astype(np.int32)
    y = rng.integers(0, ARCH["num_classes"], (8, 1)).astype(np.int32)
    np.savez(os.path.join(wd, "init.npz"), x=x, y=y,
             **{f"p|{k}": v for k, v in _weights(jm).items()})
    compiled = {"digest": strategy_digest({op.name: op.parallel_config
                                           for op in jm.layers}),
                "mesh": {a: s for a, s in jm.config.mesh_shape.items()
                         if s > 1}}
    loss = [float(jm.train_batch(x, y)) for _ in range(2)]
    # the JAX reshard's re-search (its step after the move is not run:
    # on virtual devices it fails there, placing one optimizer leaf on
    # one device)
    jm.reshard(new_mesh=JaxMesh({"n": 4}, devices=jax.devices()[:4]),
               research=True)
    after = {"digest": strategy_digest({op.name: op.parallel_config
                                        for op in jm.layers})}
    ranks = mesh_cases.spawn("searched", wd,
                             script="_torch_search_worker.py")
    return {"wd": wd, "compiled": compiled, "loss": loss, "after": after,
            "ranks": ranks}


def test_compile_search_equals_the_jax_package(runs):
    want = runs["compiled"]
    for r, res in enumerate(runs["ranks"]):
        got = res["json"]["compiled"]
        assert got["digest"] == want["digest"], r
        assert got["mesh"] == want["mesh"], r
    files = []
    for r in range(4):
        with open(os.path.join(runs["wd"], f"searched-rank{r}.pb"),
                  "rb") as f:
            files.append(f.read())
    assert len(set(files)) == 1


def test_searched_strategy_trains_as_in_the_jax_package(runs):
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["loss"], runs["loss"], rtol=RTOL,
                                   atol=ATOL)


def test_reshard_research_equals_the_jax_package(runs):
    """The re-search picks the JAX reshard's strategies; the step after
    the move is the same on every rank (the weights are whole)."""
    after = runs["after"]
    first = runs["ranks"][0]
    for res in runs["ranks"]:
        rec = res["json"]["reshard"]
        assert rec["researched"] is True and rec["mesh"] == {"n": 4}
        assert rec["digest"] == after["digest"]
        assert np.isfinite(res["loss_after"]).all()
        np.testing.assert_array_equal(res["loss_after"], first["loss_after"])
        for k in first:
            if k.startswith("param|"):
                np.testing.assert_array_equal(res[k], first[k], err_msg=k)


def test_measure_mode_broadcasts_rank_zeros_result(runs):
    recs = [res["json"]["measured"] for res in runs["ranks"]]
    assert all(r == recs[0] for r in recs)
    assert all(np.isfinite(res["measured_loss"]).all()
               for res in runs["ranks"])
