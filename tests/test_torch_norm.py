"""The port's LayerNorm against the JAX package's, on the CPU.

The plain version of the fused LayerNorm kernel
(``fused_layernorm_reference`` in ``flexflow_tpu_torch/ops/cuda_norm.py``)
is held against the JAX package's Pallas ``fused_layernorm`` (in
interpret mode, as ``tests/test_pallas_norm.py`` runs it) and against its
``_ln_reference``, with and without the residual, within 2e-6; the
gradients of the autograd function against ``jax.vjp`` within 1e-5; the
``LayerNorm`` op against the JAX op.
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
