"""The port's LayerNorm against the JAX package's, on the CPU.

The plain version of the fused LayerNorm kernel
(``fused_layernorm_reference`` in ``flexflow_tpu_torch/ops/cuda_norm.py``)
is held against the JAX package's Pallas ``fused_layernorm`` (in
interpret mode, as ``tests/test_pallas_norm.py`` runs it) and against its
``_ln_reference``, with and without the residual, within 2e-6; the
gradients of the autograd function against ``jax.vjp`` within 1e-5; the
``LayerNorm`` op against the JAX op.  The narrow output form
(``out_dtype`` = x's bf16) is held bit for bit against the float32 output
cast, in value and in gradient, and the kernel's launch plan against its
invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.norm import LayerNorm as JaxLayerNorm
from flexflow_tpu.ops.pallas_norm import _ln_reference, fused_layernorm
from flexflow_tpu.tensor import Tensor as JaxTensor
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops import cuda_norm
from flexflow_tpu_torch.ops import norm as norm_mod
from flexflow_tpu_torch.ops.norm import LayerNorm
from flexflow_tpu_torch.tensor import Tensor

EPS = 1e-5
SHAPES = [(4, 16, 64), (8, 33), (2, 7, 96)]


def _case(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(d).astype(np.float32),
            rng.standard_normal(d).astype(np.float32))


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_and_reference(shape, with_res):
    x, r, s, b = _case(shape)
    res = r if with_res else None
    pallas = fused_layernorm(jnp.asarray(x),
                             None if res is None else jnp.asarray(res),
                             jnp.asarray(s), jnp.asarray(b), EPS)
    ref = _ln_reference(jnp.asarray(x),
                        None if res is None else jnp.asarray(res),
                        jnp.asarray(s), jnp.asarray(b), EPS)
    got = cuda_norm.fused_layernorm(
        torch.from_numpy(x), None if res is None else torch.from_numpy(res),
        torch.from_numpy(s), torch.from_numpy(b), EPS)
    assert got.dtype == torch.float32
    for want in (pallas, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=0)


def test_plain_version_bf16_inputs():
    x, r, s, b = _case((4, 16, 64))
    xb, rb = jnp.asarray(x).astype(jnp.bfloat16), \
        jnp.asarray(r).astype(jnp.bfloat16)
    want = fused_layernorm(xb, rb, jnp.asarray(s), jnp.asarray(b), EPS)
    got = cuda_norm.fused_layernorm(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(r).bfloat16(),
        torch.from_numpy(s), torch.from_numpy(b), EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize("with_res", [False, True])
def test_gradients_match_jax_vjp(with_res):
    x, r, s, b = _case((4, 16, 64), seed=1)
    g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, r, s, b)]
    if with_res:
        _, vjp = jax.vjp(lambda xx, rr, ss, bb: fused_layernorm(
            xx, rr, ss, bb, EPS), *jargs)
    else:
        _, vjp = jax.vjp(lambda xx, ss, bb: fused_layernorm(
            xx, None, ss, bb, EPS), jargs[0], jargs[2], jargs[3])
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, r, s, b)]
    xx, rr, ss, bb = leaves
    y = cuda_norm.fused_layernorm_autograd(xx, rr if with_res else None, ss,
                                           bb, EPS)
    (y * torch.from_numpy(g)).sum().backward()
    got = [xx.grad, rr.grad, ss.grad, bb.grad] if with_res else [
        xx.grad, ss.grad, bb.grad]
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    if not with_res:
        assert rr.grad is None


def test_autograd_function_only_differentiates_what_asks():
    x, _, s, b = _case((3, 16))
    xx = torch.from_numpy(x).requires_grad_(True)
    y = cuda_norm.fused_layernorm_autograd(xx, None, torch.from_numpy(s),
                                           torch.from_numpy(b), EPS)
    y.sum().backward()
    assert xx.grad is not None and torch.isfinite(xx.grad).all()
    # no gradient wanted: the plain call, nothing saved
    with torch.no_grad():
        z = cuda_norm.fused_layernorm_autograd(xx, None, torch.from_numpy(s),
                                               torch.from_numpy(b), EPS)
    assert z.grad_fn is None
    assert torch.equal(z, y.detach())


@pytest.mark.parametrize("use_scale,use_bias", [(True, True), (False, True),
                                                (True, False),
                                                (False, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_op_matches_jax(use_scale, use_bias, dtype):
    shape = (3, 5, 48)
    jop = JaxLayerNorm("ln", JaxTensor(shape), EPS, use_scale, use_bias)
    op = LayerNorm("ln", Tensor(shape), EPS, use_scale, use_bias)
    assert [w.name for w in op.weights] == [w.name for w in jop.weights]
    rng = np.random.default_rng(4)
    params = {w.name: rng.standard_normal(w.shape).astype(np.float32)
              for w in jop.weights}
    x = (2 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    (want,) = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                          [jnp.asarray(x)],
                          JaxOpContext(compute_dtype=dtype))
    (got,) = op.forward({k: torch.from_numpy(v) for k, v in params.items()},
                        [torch.from_numpy(x)], OpContext(compute_dtype=dtype))
    assert str(got.dtype) == f"torch.{dtype}"
    tol = 2e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def test_float64_yardstick_and_ulp_distance():
    x, r, s, b = _case((6, 40), seed=5)
    args = [torch.from_numpy(a) for a in (x, r, s, b)]
    plain = cuda_norm.fused_layernorm_reference(*args, EPS)
    exact = cuda_norm.layernorm_float64(*args, EPS)
    assert exact.dtype == torch.float32
    assert cuda_norm.ulp_distance(plain, exact) <= 4
    one = torch.tensor([1.0, 3.0, 1e-3])
    bumped = one.clone()
    bumped[1] = torch.nextafter(bumped[1], torch.tensor(10.0))
    # the unit is the spacing at the tensor's largest value, 3.0
    assert cuda_norm.ulp_distance(bumped, one) == 1.0
    tiny = one.clone()
    tiny[2] += 2 ** -22
    assert cuda_norm.ulp_distance(tiny, one) == pytest.approx(1.0, rel=1e-3)
    # below 1 the spacing of 1 is the unit
    small = torch.tensor([0.25, -0.5])
    assert cuda_norm.ulp_distance(small + 2 ** -23, small) == \
        pytest.approx(1.0, rel=1e-3)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_plain_version_bf16_out_is_the_float32_result_cast(x_dtype,
                                                           with_res):
    x, r, s, b = (torch.from_numpy(a) for a in _case((4, 16, 64), seed=6))
    x, r = x.to(x_dtype), r.to(x_dtype)
    res = r if with_res else None
    want = cuda_norm.fused_layernorm_reference(x, res, s, b, EPS).to(
        torch.bfloat16)
    if x_dtype == torch.float32:
        # the kernel writes float32 or x's dtype, on the CPU too
        with pytest.raises(TypeError, match="float32 or x's dtype"):
            cuda_norm.fused_layernorm(x, res, s, b, EPS, torch.bfloat16)
        got = cuda_norm.fused_layernorm_reference(x, res, s, b, EPS,
                                                  torch.bfloat16)
    else:
        got = cuda_norm.fused_layernorm(x, res, s, b, EPS, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_bf16_layernorm_op_is_one_call_with_no_cast(monkeypatch):
    """In bf16 compute the op asks the kernel for bf16 and returns its
    tensor as it is: one launch on the card, no cast after it."""
    calls = []
    real = cuda_norm.fused_layernorm

    def spy(*args):
        y = real(*args)
        calls.append((args[-1], y))
        return y

    monkeypatch.setattr(cuda_norm, "fused_layernorm", spy)
    shape = (3, 5, 48)
    op = LayerNorm("ln", Tensor(shape), EPS)
    rng = np.random.default_rng(8)
    params = {w.name: torch.from_numpy(
        rng.standard_normal(w.shape).astype(np.float32)) for w in op.weights}
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    for x_in, compute, out in ((x.bfloat16(), "bfloat16", torch.bfloat16),
                               (x, "float32", torch.float32),
                               (x, "bfloat16", torch.float32)):
        calls.clear()
        (got,) = op.forward(params, [x_in], OpContext(compute_dtype=compute))
        assert [c[0] for c in calls] == [out]
        assert str(got.dtype) == f"torch.{compute}"
        if out == got.dtype:
            assert got is calls[0][1]


@pytest.mark.parametrize("with_res", [False, True])
def test_bf16_out_gradients_equal_the_float32_then_cast_path(with_res):
    x, r, s, b = _case((4, 16, 64), seed=9)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        x.shape).astype(np.float32)).bfloat16()
    grads = []
    for narrow in (False, True):
        leaves = [torch.from_numpy(x).bfloat16().requires_grad_(True),
                  torch.from_numpy(r).bfloat16().requires_grad_(True),
                  torch.from_numpy(s).requires_grad_(True),
                  torch.from_numpy(b).requires_grad_(True)]
        xx, rr, ss, bb = leaves
        rr_in = rr if with_res else None
        if narrow:
            y = cuda_norm.fused_layernorm_autograd(xx, rr_in, ss, bb, EPS,
                                                   torch.bfloat16)
        else:
            y = cuda_norm.fused_layernorm_autograd(xx, rr_in, ss, bb,
                                                   EPS).to(torch.bfloat16)
        assert y.dtype == torch.bfloat16
        y.backward(g)
        grads.append([t.grad for t in leaves])
    for old, new in zip(*grads):
        if old is None:
            assert new is None
        else:
            assert new.dtype == old.dtype and torch.equal(new, old)
    assert (grads[1][1] is None) == (not with_res)


def test_bf16_layernorm_op_gradients_equal_the_float32_then_cast_path(
        monkeypatch):
    shape = (2, 6, 40)
    op = LayerNorm("ln", Tensor(shape), EPS)
    rng = np.random.default_rng(11)
    base = {w.name: rng.standard_normal(w.shape).astype(np.float32)
            for w in op.weights}
    x = rng.standard_normal(shape).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()
    real = cuda_norm.fused_layernorm_autograd

    def float32_out(x, res, scale, bias, eps, out_dtype):
        return real(x, res, scale, bias, eps)

    grads = []
    for old in (True, False):
        if old:   # the op as it was: float32 out, cast by the op
            monkeypatch.setattr(norm_mod, "fused_layernorm_autograd",
                                float32_out)
        else:
            monkeypatch.undo()
        params = {k: torch.from_numpy(v).requires_grad_(True)
                  for k, v in base.items()}
        xx = torch.from_numpy(x).bfloat16().requires_grad_(True)
        (y,) = op.forward(params, [xx], OpContext(compute_dtype="bfloat16"))
        y.backward(g)
        grads.append([xx.grad] + [params[w.name].grad for w in op.weights])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _plan_cases():
    for rows in (1, 3, 16, 100, 256, 1000, 8192, 200_000):
        for itemsize in (2, 4):
            for out_itemsize in sorted({itemsize, 4}):
                for aligned in (True, False):
                    for sms in (16, 132):
                        yield rows, itemsize, out_itemsize, aligned, sms


@pytest.mark.parametrize("d", [1, 4, 7, 64, 77, 768, 777, 1024, 4096,
                               14336])
def test_launch_plan_invariants(d):
    for rows, itemsize, out_itemsize, aligned, sms in _plan_cases():
        p = cuda_norm.launch_plan(rows, d, itemsize, out_itemsize, aligned,
                                  sms)
        case = (rows, d, itemsize, out_itemsize, aligned, sms, p)
        # the vector path only where the row is whole 16-byte vectors
        if p.vec > 1:
            assert aligned and p.vec * itemsize == 16 and d % p.vec == 0, \
                case
        else:
            assert not aligned or (d * itemsize) % 16, case
        nvec = d // p.vec
        # threads a row a power of two; a block whole warps, within the cap
        assert p.tpr & (p.tpr - 1) == 0, case
        threads = p.tpr * p.rpb
        assert threads % 32 == 0 and threads <= cuda_norm.MAX_THREADS, case
        # a thread's share fits the vectors it is compiled to hold, and no
        # thread holds more values than its register cap
        assert -(-nvec // p.tpr) <= p.nv, case
        assert p.nv * p.vec <= cuda_norm.MAX_VALUES, case
        assert (p.nv in cuda_norm.NV_CHOICES if p.vec > 1
                else p.nv == cuda_norm.MAX_VALUES), case
        # a 16-byte thread holds at most MAX_HELD vectors where a row has
        # threads to spare
        if p.vec > 1 and p.tpr < min(nvec, cuda_norm.MAX_THREADS):
            assert -(-nvec // p.tpr) <= cuda_norm.MAX_HELD, case
        # every row is one block's, exactly once
        assert p.blocks * p.rpb >= rows > (p.blocks - 1) * p.rpb, case
        # thread t of a row holds vectors t, t + tpr, ...: each once
        held = np.zeros(nvec, np.int64)
        for t in range(min(p.tpr, nvec)):
            held[t::p.tpr] += 1
        assert (held == 1).all(), case


def test_launch_plan_at_the_main_paths_shapes():
    # (vec, vectors a thread, threads a row, rows a block, blocks): a
    # decode step's 16 rows and a prefill chunk's 256 spread a bf16 row
    # over 4 warps, one 16-byte vector a thread
    plan = cuda_norm.launch_plan
    for out_itemsize in (2, 4):
        assert plan(16, 768, 2, out_itemsize, True) == (8, 1, 128, 1, 16)
        assert plan(256, 768, 2, out_itemsize, True) == (8, 1, 128, 1, 256)
    # BERT-base's 8192 bf16 rows take a warp a row, 3 vectors a thread,
    # compiled for 4 when the output is float32; its float32 rows take 2
    # warps a row, so a thread holds 3 vectors and not 6
    assert plan(8192, 768, 2, 2, True) == (8, 3, 32, 1, 8192)
    assert plan(8192, 768, 2, 4, True) == (8, 4, 32, 1, 8192)
    assert plan(8192, 768, 4, 4, True) == (4, 3, 64, 1, 8192)
    # rows narrower than a warp share one
    assert plan(100, 40, 4, 4, True) == (4, 1, 16, 2, 50)
    # a misaligned view takes single elements
    assert plan(16, 768, 2, 2, False)[:2] == (1, cuda_norm.MAX_VALUES)
    # a card of fewer SMs is half filled by fewer threads a row
    assert plan(256, 768, 2, 2, True, 16) == (8, 2, 64, 1, 256)
