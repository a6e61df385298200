"""The port's max pool against the JAX package's.

The plain PyTorch version (``max_pool_nhwc_reference``, what the CUDA
kernel is held against on the card) must be bit-equal to the Pallas
kernel ``pallas_max_pool_nhwc`` run in interpret mode, and the port's
``Pool2D`` must match the JAX ``Pool2D`` forward.  The CUDA kernel
itself is held against the plain version in ``test_torch_cuda.py``.
"""

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

ALEXNET = [((2, 56, 56, 64), (3, 3), (2, 2), (0, 0)),
           ((2, 27, 27, 192), (3, 3), (2, 2), (0, 0)),
           ((2, 13, 13, 256), (3, 3), (2, 2), (0, 0))]


def _nhwc_input(shape, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(-2, 3, shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "nan":
        x[rng.random(shape) < 0.02] = np.nan
        x[rng.random(shape) < 0.02] = -np.inf
    return x


def _port_pool(x_nhwc, kernel, stride, padding, dtype=torch.float32):
    # NHWC memory under the logical NCHW shape: torch.channels_last
    xt = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    y = cuda_pool.max_pool_nhwc(xt, kernel, stride, padding)
    return y.permute(0, 2, 3, 1).to(torch.float32).numpy()


@pytest.mark.parametrize(
    "shape,kernel,stride,padding,kind,dtype",
    [c + ("normal", "float32") for c in PALLAS_CASES]
    + [c + ("normal", "float32") for c in ALEXNET]
    + [ALEXNET[1] + ("normal", "bfloat16"),
       ((2, 13, 13, 8), (3, 3), (2, 2), (1, 1), "ties", "bfloat16"),
       ((2, 13, 13, 8), (3, 3), (2, 2), (1, 1), "nan", "float32"),
       ((1, 9, 9, 16), (2, 2), (2, 2), (0, 0), "nan", "bfloat16")])
def test_plain_version_bit_equal_to_pallas(shape, kernel, stride, padding,
                                          kind, dtype):
    x = _nhwc_input(shape, seed=sum(shape), kind=kind)
    y_jax = pallas_max_pool_nhwc(jnp.asarray(x, getattr(jnp, dtype)),
                                 kernel, stride, padding)
    y = _port_pool(x, kernel, stride, padding, getattr(torch, dtype))
    np.testing.assert_array_equal(y, np.asarray(y_jax, np.float32))


@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("geom", [(3, 3, 2, 2, 0, 0), (3, 3, 2, 2, 1, 1),
                                  (2, 3, 1, 2, 1, 0)])
def test_pool2d_matches_jax_op(pool_type, layout, geom):
    shape = (2, 6, 11, 12)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    jop = JaxPool2D("p", JaxTensor(shape, "float32", name="x"), *geom,
                    pool_type=pool_type)
    (want,) = jop.forward({}, [jnp.asarray(x)],
                          JaxOpContext(compute_dtype="float32"))
    op = Pool2D("p", Tensor(shape, "float32", name="x"), *geom,
                pool_type=pool_type)
    (got,) = op.forward({}, [torch.from_numpy(x)],
                        OpContext(compute_dtype="float32",
                                  conv_layout=layout))
    assert tuple(got.shape) == tuple(op.outputs[0].shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_integer_max_pool_takes_plain_version():
    """Non-float pools route to the plain version by dtype, before the
    kernel wrapper is reached (the kernel takes floats only)."""
    shape = (2, 3, 9, 9)
    x = np.random.default_rng(3).integers(-50, 50, shape).astype(np.int32)
    jop = JaxPool2D("p", JaxTensor(shape, "int32", name="x"), 3, 3, 2, 2,
                    1, 1)
    (want,) = jop.forward({}, [jnp.asarray(x)],
                          JaxOpContext(compute_dtype="float32"))
    op = Pool2D("p", Tensor(shape, "int32", name="x"), 3, 3, 2, 2, 1, 1)
    before = cuda_pool.max_pool_nhwc.launches
    (got,) = op.forward({}, [torch.from_numpy(x)],
                        OpContext(compute_dtype="float32"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cuda_pool.max_pool_nhwc.launches == before


def test_cpu_tensor_launches_nothing():
    x = torch.from_numpy(_nhwc_input((2, 9, 9, 8), 1)).permute(0, 3, 1, 2)
    before = cuda_pool.max_pool_nhwc.launches
    cuda_pool.max_pool_nhwc(x, (3, 3), (2, 2), (0, 0))
    assert cuda_pool.max_pool_nhwc.launches == before == 0


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor may take the plain version: any other device
    launches the kernel or raises."""
    x = torch.empty((2, 8, 9, 9), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_pool.max_pool_nhwc(x, (3, 3), (2, 2), (0, 0))


def test_plain_version_accepts_padding_above_half_the_window():
    """JAX accepts padding > kernel/2 (F.max_pool2d does not): the
    padded positions hold finfo.min, so an all-padding window gives
    finfo.min, as the Pallas kernel pads."""
    x = torch.zeros((1, 1, 2, 2))
    y = cuda_pool.max_pool_nhwc_reference(x, (2, 2), (2, 2), (2, 2))
    assert tuple(y.shape) == (1, 1, 3, 3)
    assert float(y[0, 0, 0, 0]) == torch.finfo(torch.float32).min
    assert float(y[0, 0, 1, 1]) == 0.0
