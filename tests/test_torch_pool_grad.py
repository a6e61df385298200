"""The port's max-pool gradient against the JAX package's.

The plain backward (``max_pool_nhwc_backward_reference``, what the CUDA
backward kernel is held against on the card) must be bit-equal to
``jax.grad`` of the Pallas kernel ``pallas_max_pool_nhwc`` (its
``_pool_bwd`` runs in interpret mode on the CPU) on integer-valued
float32 inputs and cotangents, where every sum is exact.  In bfloat16
XLA on the CPU may keep a sum in float32 before it rounds, so that case
is held within 1e-2.  ``Pool2D`` under autograd must give the JAX
``Pool2D``'s input gradient in both layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.conv import Pool2D as JaxPool2D
from flexflow_tpu.ops.pallas_pool import pallas_max_pool_nhwc
from flexflow_tpu.tensor import Tensor as JaxTensor
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops import cuda_pool
from flexflow_tpu_torch.ops.conv import Pool2D
from flexflow_tpu_torch.tensor import Tensor
from tests.test_pallas_pool import CASES as PALLAS_CASES
from tests.test_torch_pool import ALEXNET


def _inputs(shape, kernel, stride, padding, kind, seed):
    """NHWC integer-valued x (ties, NaN and -inf on request) and an
    integer-valued cotangent of the pool output."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = np.zeros(shape, np.float32)
    else:
        x = rng.integers(-8, 8, shape).astype(np.float32)
    if kind == "nan":
        x[rng.random(shape) < 0.05] = np.nan
        x[rng.random(shape) < 0.05] = -np.inf
    n, h, w, c = shape
    oh, ow = cuda_pool.out_hw(h, w, kernel, stride, padding)
    ct = rng.integers(1, 5, (n, oh, ow, c)).astype(np.float32)
    return x, ct


def _jax_grad(x, ct, kernel, stride, padding, dtype=jnp.float32):
    def f(v):
        y = pallas_max_pool_nhwc(v, kernel, stride, padding)
        return jnp.vdot(y.astype(jnp.float32), jnp.asarray(ct))

    return np.asarray(jax.jit(jax.grad(f))(jnp.asarray(x, dtype)),
                      np.float32)


def _port_grad(x, ct, kernel, stride, padding, dtype=torch.float32):
    # NHWC memory under the logical NCHW shape: torch.channels_last
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    g = torch.from_numpy(ct).to(dtype).permute(0, 3, 1, 2)
    dx = cuda_pool.max_pool_nhwc_backward(xt, g, kernel, stride, padding)
    assert dx.dtype == dtype and dx.shape == xt.shape
    assert dx.is_contiguous(memory_format=torch.channels_last)
    return dx.permute(0, 2, 3, 1).to(torch.float32).numpy()


@pytest.mark.parametrize(
    "shape,kernel,stride,padding,kind",
    [c + ("normal",) for c in PALLAS_CASES]
    + [c + ("normal",) for c in ALEXNET]
    + [((1, 6, 6, 8), (2, 2), (2, 2), (0, 0), "ties"),
       ((2, 13, 13, 8), (3, 3), (2, 2), (1, 1), "ties"),
       ((2, 13, 13, 8), (3, 3), (2, 2), (1, 1), "nan"),
       ((1, 9, 9, 16), (3, 3), (1, 1), (1, 1), "nan"),
       ((2, 9, 9, 8), (3, 3), (1, 1), (2, 2), "normal")])
def test_plain_backward_bit_equal_to_pallas_grad(shape, kernel, stride,
                                                 padding, kind):
    x, ct = _inputs(shape, kernel, stride, padding, kind, seed=sum(shape))
    want = _jax_grad(x, ct, kernel, stride, padding)
    got = _port_grad(x, ct, kernel, stride, padding)
    np.testing.assert_array_equal(got, want)
    if kind == "ties":
        # all-equal windows: the gradient goes to each window's
        # row-major first position only
        assert np.count_nonzero(got) <= np.count_nonzero(ct)


def test_nan_window_routes_no_gradient():
    """A window whose max is NaN routes nothing (the Pallas kernel's
    wv == y is false for NaN); -0.0 equals +0.0; what lands in the
    padding is dropped."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 0, 0, 0] = np.nan
    x[0, 2, 2, 0] = -0.0
    ct = np.ones((1, 2, 2, 1), np.float32)
    want = _jax_grad(x, ct, (2, 2), (2, 2), (0, 0))
    got = _port_grad(x, ct, (2, 2), (2, 2), (0, 0))
    np.testing.assert_array_equal(got, want)
    assert got[0, :2, :2, 0].sum() == 0.0
    assert got[0, 2, 2, 0] == 1.0
    # -inf inputs: a window that holds padding has the pad value as its
    # max and drops its gradient; only the window wholly inside x routes
    x = np.full((1, 2, 2, 1), -np.inf, np.float32)
    ct = np.ones((1, 3, 3, 1), np.float32)
    want = _jax_grad(x, ct, (2, 2), (2, 2), (2, 2))
    got = _port_grad(x, ct, (2, 2), (2, 2), (2, 2))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 1.0 and got[0, 0, 0, 0] == 1.0


def test_plain_backward_bf16_close_to_pallas_grad():
    rng = np.random.default_rng(1)
    shape, k, s, p = (2, 13, 13, 16), (3, 3), (2, 2), (1, 1)
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal((2, 7, 7, 16)).astype(np.float32)
    ct_bf16 = np.asarray(jnp.asarray(ct, jnp.bfloat16), np.float32)
    want = _jax_grad(x, ct_bf16, k, s, p, jnp.bfloat16)
    got = _port_grad(x, ct_bf16, k, s, p, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_backward_takes_any_gradient_memory_format():
    x, ct = _inputs((2, 9, 9, 8), (3, 3), (2, 2), (0, 0), "normal", 5)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    g = torch.from_numpy(ct).permute(0, 3, 1, 2)
    a = cuda_pool.max_pool_nhwc_backward(xt, g, (3, 3), (2, 2), (0, 0))
    b = cuda_pool.max_pool_nhwc_backward(xt, g.contiguous(), (3, 3),
                                         (2, 2), (0, 0))
    assert torch.equal(a, b)


def test_backward_cpu_launches_nothing_and_other_devices_raise():
    x = torch.zeros((1, 2, 4, 4))
    g = torch.ones((1, 2, 2, 2))
    before = cuda_pool.max_pool_nhwc_backward.launches
    cuda_pool.max_pool_nhwc_backward(x, g, (2, 2), (2, 2), (0, 0))
    assert cuda_pool.max_pool_nhwc_backward.launches == before
    with pytest.raises(ValueError, match="unsupported devices"):
        cuda_pool.max_pool_nhwc_backward(x.to("meta"), g.to("meta"),
                                         (2, 2), (2, 2), (0, 0))
    with pytest.raises(ValueError, match="does not match"):
        cuda_pool.max_pool_nhwc_backward_reference(
            x, torch.ones((1, 2, 3, 3)), (2, 2), (2, 2), (0, 0))


def test_autograd_saves_nothing_without_grad():
    x = torch.arange(50.0).reshape(1, 2, 5, 5).requires_grad_(True)
    with torch.inference_mode():
        y = cuda_pool.max_pool_nhwc_autograd(x, (3, 3), (2, 2), (0, 0))
    assert y.grad_fn is None
    y = cuda_pool.max_pool_nhwc_autograd(x, (3, 3), (2, 2), (0, 0))
    assert type(y.grad_fn).__name__ == "MaxPoolNHWCBackward"


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("geom", [(3, 3, 2, 2, 0, 0), (3, 3, 2, 2, 1, 1),
                                  (2, 3, 1, 2, 1, 0)])
def test_pool2d_gradient_matches_jax_op(monkeypatch, layout, geom):
    """The JAX op runs its Pallas kernels under nhwc (FF_PALLAS_POOL=1)
    and reduce_window autodiff under nchw; the port runs its autograd
    function in both."""
    monkeypatch.setenv("FF_PALLAS_POOL", "1")
    shape = (2, 6, 11, 12)
    rng = np.random.default_rng(7)
    x = rng.integers(-8, 8, shape).astype(np.float32)
    jop = JaxPool2D("p", JaxTensor(shape, "float32", name="x"), *geom)
    ct = rng.integers(1, 5, jop.outputs[0].shape).astype(np.float32)
    jctx = JaxOpContext(compute_dtype="float32", conv_layout=layout)

    def f(v):
        (y,) = jop.forward({}, [v], jctx)
        return jnp.vdot(y, jnp.asarray(ct))

    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(x)))
    op = Pool2D("p", Tensor(shape, "float32", name="x"), *geom)
    xt = torch.from_numpy(x).requires_grad_(True)
    (y,) = op.forward({}, [xt], OpContext(compute_dtype="float32",
                                          conv_layout=layout))
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
