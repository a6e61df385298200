"""The port's transformer on a mesh of four CPU ranks (gloo,
``_torch_mesh_worker.py``) against the JAX package on the same mesh and
the port's one-device run: the multichip dryrun's transformer with
ring attention at {"s": 2, "c": 2}, heads split at {"n": 2, "c": 2}, a
batch the n axis does not divide, and dropout under the ring; and ring
attention alone at {"s": 4} against dense attention, with gradients.

Tolerances: rtol 1e-4, atol 1e-5 on losses and parameters
(``tests/test_parallel.py``); ring attention 1e-5 on outputs and 1e-4
on gradients (``tests/test_transformer.py``), float32 throughout."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
from flexflow_tpu.ops.attention import ring_attention as jax_ring
from flexflow_tpu_torch.ops.attention import _dense_attention
from test_torch_mesh import ATOL, RTOL, jax_mesh, reference_runs

TRAINED = ("tf_s2c2", "tf_n2c2", "tf_nondiv", "tf_dropout")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("mesh_transformer"))
    jruns, one = reference_runs(TRAINED, wd)
    return {"jax": jruns, "one": one,
            "ranks": cases.spawn("transformer", wd)}


@pytest.mark.parametrize("name", ["tf_s2c2", "tf_n2c2", "tf_nondiv"])
def test_mesh_step_matches_jax_and_one_device(runs, name):
    jl, jw, _ = runs["jax"][name]
    ol, ow = runs["one"][name]
    for res in runs["ranks"]:
        loss = res[f"{name}|loss"]
        np.testing.assert_allclose(loss, jl, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(loss, ol, rtol=RTOL, atol=ATOL)
        for k in jw:
            got = res[f"{name}|param|{k}"]
            np.testing.assert_allclose(got, jw[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
            np.testing.assert_allclose(got, ow[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_heads_split_over_c(runs):
    """At {"n": 2, "c": 2} with the attention on c each rank holds half
    the heads' projections (q/k/v by output row, the output projection
    by input column) and the LayerNorms whole."""
    for res in runs["ranks"]:
        local = res["json"]["tf_n2c2"]["local"]
        assert local["attention_0/wq"] == [16, 32]
        assert local["attention_0/wo"] == [32, 16]
        assert local["ln_attn_0/scale"] == [32]


def test_ring_attention_dropout_trains(runs):
    """Dropout under the ring (masks drawn per block pair, so only
    finiteness and progress compare, as in the JAX package's test)."""
    for res in runs["ranks"]:
        losses = res["tf_dropout|loss"]
        assert np.all(np.isfinite(losses))
        assert losses[-1] < losses[0]


def _qkv():
    rng = np.random.default_rng(1)
    return [rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
            for _ in range(3)]


@functools.cache
def _dense(causal):
    """The port's dense attention and the gradients of sum(out**2)."""
    qkv = [torch.from_numpy(a).requires_grad_() for a in _qkv()]
    out = _dense_attention(*qkv, causal, 0.35, 0.0, None)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in qkv]


@functools.cache
def _jax_ring(causal):
    mesh = jax_mesh({"s": 4})
    q, k, v = (jnp.asarray(a) for a in _qkv())
    out = jax_ring(q, k, v, mesh, causal, 0.35)
    grads = jax.grad(lambda q, k, v: jnp.sum(
        jax_ring(q, k, v, mesh, causal, 0.35) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
def test_ring_attention_matches_dense(runs, causal, what):
    """Ring attention at {"s": 4} equals dense attention, causal and not,
    with its gradients; and the JAX package's ring on the same mesh."""
    d_out, d_grads = _dense(causal)
    j_out, j_grads = _jax_ring(causal)
    tol = 1e-5 if what == "out" else 1e-4
    dense = d_out if what == "out" else d_grads["qkv".index(what[1])]
    ref = j_out if what == "out" else j_grads["qkv".index(what[1])]
    for res in runs["ranks"]:
        got = res[f"ring|{causal}|{what}"]
        np.testing.assert_allclose(got, dense, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
