"""The port's attention against the JAX package's, on the CPU.

The plain versions of the flash-attention kernels
(``flash_attention_reference`` and ``flash_attention_backward_reference``
in ``flexflow_tpu_torch/ops/cuda_attention.py``) are held against the
JAX package's ``_dense_attention`` and its ``jax.vjp`` in float32, causal
and not, at a ragged length too: forward within 1e-6, gradients within
1e-5 (the two frameworks sum in other orders).  The ``MultiHeadAttention``
op, with the same weights, is held against the JAX op's ``forward``
(1e-6 in float32, 1e-2 in bfloat16, where the two round at other
places), and so are ``PositionEmbedding`` and ``Embedding``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.attention import MultiHeadAttention as JaxMHA
from flexflow_tpu.ops.attention import PositionEmbedding as JaxPosEmb
from flexflow_tpu.ops.attention import _dense_attention as jax_dense
from flexflow_tpu.ops.linear import Embedding as JaxEmbedding
from flexflow_tpu.tensor import Tensor as JaxTensor
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops import cuda_attention
from flexflow_tpu_torch.ops.attention import (MultiHeadAttention,
                                              PositionEmbedding,
                                              _dense_attention, use_flash)
from flexflow_tpu_torch.ops.linear import Embedding
from flexflow_tpu_torch.tensor import Tensor

SHAPES = [(2, 32, 4, 16), (2, 128, 2, 64), (2, 77, 3, 32)]


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax_dense_attention(shape, causal):
    q, k, v = _qkv(shape)
    scale = 1.0 / math.sqrt(shape[-1])
    want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                     scale, 0.0, None)
    got = cuda_attention.flash_attention_reference(*_t(q, k, v), causal,
                                                   scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # the op's dense path is the same function
    dense = _dense_attention(*_t(q, k, v), causal, scale, 0.0, None)
    assert torch.equal(dense, got)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(shape, causal):
    q, k, v = _qkv(shape)
    do = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    scale = 1.0 / math.sqrt(shape[-1])
    _, vjp = jax.vjp(lambda a, b, c: jax_dense(a, b, c, causal, scale, 0.0,
                                               None),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, k, v)
    o, lse = cuda_attention.flash_attention_forward(tq, tk, tv, causal,
                                                    scale)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(
            jnp.einsum("nqhd,nkhd->nhqk", q, k) * scale
            + jnp.where(causal & (np.arange(shape[1])[None, :]
                                  > np.arange(shape[1])[:, None]),
                        -1e30, 0.0), axis=-1)), atol=1e-5, rtol=0)
    got = cuda_attention.flash_attention_backward(
        tq, tk, tv, o, lse, torch.from_numpy(do), causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_on_the_cpu_matches_jax_vjp(causal):
    """``flash_attention`` under autograd on CPU tensors: the plain
    forward and the plain backward, paired by ``FlashAttention``."""
    shape = (2, 40, 2, 16)
    q, k, v = _qkv(shape, seed=3)
    do = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    scale = 0.25
    _, vjp = jax.vjp(lambda a, b, c: jax_dense(a, b, c, causal, scale, 0.0,
                                               None),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    out = cuda_attention.flash_attention(*leaves, causal, scale)
    (out * torch.from_numpy(do)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_selection_rule():
    q, k, v = _t(*_qkv((1, 8, 2, 16)))
    # the CPU always takes the dense path
    assert not use_flash(q, k, v, None, False)
    assert not use_flash(q, k, v, True, False)
    # what the kernel takes, whatever the device
    assert cuda_attention.kernel_takes(q, k, v)
    assert cuda_attention.kernel_takes(q.bfloat16(), k.bfloat16(),
                                       v.bfloat16())
    assert not cuda_attention.kernel_takes(q.double(), k.double(),
                                           v.double())
    assert not cuda_attention.kernel_takes(q, k.bfloat16(), v)
    wide = torch.zeros((1, 8, 1, 160))
    assert not cuda_attention.kernel_takes(wide, wide, wide)


def _mha_pair(n=2, s=24, d=32, heads=4, causal=False, dropout=0.0):
    jx = JaxTensor((n, s, d), name="x")
    jop = JaxMHA("attention", jx, jx, jx, d, heads, dropout=dropout,
                 causal=causal)
    tx = Tensor((n, s, d), name="x")
    op = MultiHeadAttention("attention", tx, tx, tx, d, heads,
                            dropout=dropout, causal=causal)
    rng = np.random.default_rng(7)
    params = {w.name: (0.1 * rng.standard_normal(w.shape)).astype(np.float32)
              for w in jop.weights}
    assert sorted(params) == sorted(w.name for w in op.weights)
    assert all(tuple(w.shape) == params[w.name].shape for w in op.weights)
    x = rng.standard_normal((n, s, d)).astype(np.float32)
    return jop, op, params, x


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 1e-2)])
def test_multihead_attention_matches_jax(causal, dtype, tol):
    jop, op, params, x = _mha_pair(causal=causal)
    (want,) = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                          [jnp.asarray(x)],
                          JaxOpContext(training=False, compute_dtype=dtype))
    (got,) = op.forward({k: torch.from_numpy(v) for k, v in params.items()},
                        [torch.from_numpy(x)],
                        OpContext(compute_dtype=dtype))
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def test_attention_dropout_draws_from_the_op_generator():
    _, op, params, x = _mha_pair(dropout=0.5)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    run = [op.forward(tp, [torch.from_numpy(x)],
                      OpContext(compute_dtype="float32", training=True,
                                seed=s))[0] for s in (5, 5, 6)]
    plain = op.forward(tp, [torch.from_numpy(x)],
                       OpContext(compute_dtype="float32"))[0]
    assert torch.equal(run[0], run[1])          # same step, same mask
    assert not torch.equal(run[0], run[2])      # another step
    assert not torch.equal(run[0], plain)       # dropout acted
    assert torch.isfinite(run[0]).all()


def test_position_embedding_matches_jax():
    n, s, d, max_len = 2, 12, 16, 20
    jop = JaxPosEmb("pos_embedding", JaxTensor((n, s, d)), max_len)
    op = PositionEmbedding("pos_embedding", Tensor((n, s, d)), max_len)
    rng = np.random.default_rng(2)
    table = rng.standard_normal((max_len, d)).astype(np.float32)
    x = rng.standard_normal((n, s, d)).astype(np.float32)
    name = op.w_table.name
    assert name == jop.w_table.name and op.w_table.shape == (max_len, d)
    (want,) = jop.forward({name: jnp.asarray(table)}, [jnp.asarray(x)],
                          JaxOpContext(compute_dtype="float32"))
    (got,) = op.forward({name: torch.from_numpy(table)},
                        [torch.from_numpy(x)],
                        OpContext(compute_dtype="float32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


@pytest.mark.parametrize("aggr,ids_shape", [("none", (3, 7)),
                                            ("sum", (3, 5)),
                                            ("avg", (3, 5))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_matches_jax(aggr, ids_shape, dtype):
    vocab, d = 30, 8
    jop = JaxEmbedding("embedding", JaxTensor(ids_shape, "int32"), vocab, d,
                       aggr)
    op = Embedding("embedding", Tensor(ids_shape, "int32"), vocab, d, aggr)
    assert op.outputs[0].shape == jop.outputs[0].shape
    rng = np.random.default_rng(3)
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    ids = rng.integers(0, vocab, ids_shape).astype(np.int32)
    name = op.w_table.name
    (want,) = jop.forward({name: jnp.asarray(table)}, [jnp.asarray(ids)],
                          JaxOpContext(compute_dtype=dtype))
    (got,) = op.forward({name: torch.from_numpy(table)},
                        [torch.from_numpy(ids)],
                        OpContext(compute_dtype=dtype))
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-6,
                               rtol=0)


def test_embedding_refuses_an_unknown_aggregation():
    with pytest.raises(ValueError, match="aggr"):
        Embedding("embedding", Tensor((2, 3), "int32"), 10, 4, "max")


def test_embedding_refuses_unported_placements():
    """A host-placed table gathers on the host; one that is not on the
    host raises rather than gather on the device.  Sparse row updates
    asked for explicitly are ported, so compile takes them and puts the
    table on that path."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.config import DeviceType, ParallelConfig

    op = Embedding("embedding", Tensor((2, 3), "int32"), 10, 4, "none")
    op.parallel_config = ParallelConfig(device_type=DeviceType.HOST)
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    ids = torch.tensor([[1, 2, 3], [4, 5, 9]], dtype=torch.int32)
    (y,) = op.forward({op.w_table.name: table}, [ids],
                      OpContext(compute_dtype="float32"))
    torch.testing.assert_close(y, table[ids.long()], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="not on the host"):
        op.forward({op.w_table.name: table.to("meta")}, [ids], OpContext())
    m = ft.FFModel(ft.FFConfig(batch_size=2,
                               sparse_embedding_updates=True), device="cpu")
    m.embedding(m.create_tensor((2, 3), "int32"), 10, 4)
    m.compile(ft.SGDOptimizer(lr=0.01))
    assert m._sparse_specs == [("embedding", "embedding/table", 0)]
