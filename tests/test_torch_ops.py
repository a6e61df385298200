"""The port's operators against the JAX package's, in float32.

The same seeded numpy inputs and parameters go through each JAX op's
``forward`` and its counterpart in ``flexflow_tpu_torch``.  Tolerances:
1e-5 for elementwise ops and matmuls; 1e-4 for convolutions, whose sums
run in another order (XLA vs oneDNN) over up to 363 terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import initializers as jinit
from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.common import apply_activation as jax_activation
from flexflow_tpu.ops.conv import Conv2D as JaxConv2D
from flexflow_tpu.ops.linear import Linear as JaxLinear
from flexflow_tpu.ops.tensor_ops import Flat as JaxFlat
from flexflow_tpu.ops.tensor_ops import Softmax as JaxSoftmax
from flexflow_tpu.tensor import Tensor as JaxTensor
from flexflow_tpu_torch import initializers as tinit
from flexflow_tpu_torch.config import ParallelConfig
from flexflow_tpu_torch.op import OpContext, resolve_conv_layout
from flexflow_tpu_torch.ops.common import (apply_activation, cast_compute,
                                           resolve_op_dtype)
from flexflow_tpu_torch.ops.conv import Conv2D
from flexflow_tpu_torch.ops.linear import Linear
from flexflow_tpu_torch.ops.tensor_ops import Flat, Softmax
from flexflow_tpu_torch.tensor import Tensor

JCTX = JaxOpContext(compute_dtype="float32")


def _ctx(layout="nchw"):
    return OpContext(compute_dtype="float32", conv_layout=layout)


def _params(op, seed):
    rng = np.random.default_rng(seed)
    return {w.name: (0.2 * rng.standard_normal(w.shape)).astype(np.float32)
            for w in op.weights}


def _run_both(jop, op, x, seed, layout="nchw"):
    params = _params(jop, seed)
    assert sorted(params) == sorted(w.name for w in op.weights)
    (want,) = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                          [jnp.asarray(x)], JCTX)
    (got,) = op.forward({k: torch.from_numpy(v) for k, v in params.items()},
                        [torch.from_numpy(x)], _ctx(layout))
    assert tuple(got.shape) == tuple(op.outputs[0].shape)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("shape,args,act", [
    ((2, 3, 31, 31), (8, 11, 11, 4, 4, 2, 2), "relu"),   # AlexNet stem
    ((2, 8, 9, 9), (6, 3, 3, 1, 1, 1, 1), None),
    ((1, 4, 12, 10), (5, 5, 5, 1, 1, 2, 2), "sigmoid"),
    ((2, 6, 8, 8), (4, 3, 2, 2, 1, 0, 1), "tanh"),
])
def test_conv2d_matches_jax(layout, shape, args, act):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jop = JaxConv2D("c", JaxTensor(shape, name="x"), *args, activation=act)
    op = Conv2D("c", Tensor(shape, name="x"), *args, activation=act)
    got, want = _run_both(jop, op, x, seed=2, layout=layout)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,out_dim,act,bias", [
    ((4, 12), 7, "relu", True),
    ((3, 5, 12), 9, None, True),
    ((6, 16), 10, "gelu", False),
])
def test_linear_matches_jax(shape, out_dim, act, bias):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jop = JaxLinear("d", JaxTensor(shape, name="x"), out_dim, act, bias)
    op = Linear("d", Tensor(shape, name="x"), out_dim, act, bias)
    got, want = _run_both(jop, op, x, seed=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_flat_matches_jax_in_either_memory_format(layout):
    shape = (2, 3, 4, 5)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    (want,) = JaxFlat("f", JaxTensor(shape, name="x")).forward(
        {}, [jnp.asarray(x)], JCTX)
    xt = torch.from_numpy(x)
    if layout == "nhwc":
        xt = xt.contiguous(memory_format=torch.channels_last)
    op = Flat("f", Tensor(shape, name="x"))
    (got,) = op.forward({}, [xt], _ctx(layout))
    assert tuple(got.shape) == tuple(op.outputs[0].shape) == (2, 60)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,axis", [((4, 10), -1), ((2, 5, 7), 1)])
def test_softmax_matches_jax(shape, axis):
    x = 3 * np.random.default_rng(6).standard_normal(shape).astype(
        np.float32)
    (want,) = JaxSoftmax("s", JaxTensor(shape, name="x"), axis).forward(
        {}, [jnp.asarray(x)], JCTX)
    (got,) = Softmax("s", Tensor(shape, name="x"), axis).forward(
        {}, [torch.from_numpy(x)], _ctx())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act", [None, "none", "relu", "sigmoid", "tanh",
                                 "elu", "gelu", "exp", "silu", "softmax"])
def test_activation_matches_jax(act):
    x = 2 * np.random.default_rng(7).standard_normal((5, 9)).astype(
        np.float32)
    want = np.asarray(jax_activation(jnp.asarray(x), act))
    got = apply_activation(torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        apply_activation(torch.zeros(2), "swish2")


@pytest.mark.parametrize("shape", [(8, 3, 5, 5), (64, 3, 11, 11),
                                   (7, 12), (300, 40), (5,)])
def test_glorot_fan_rules_match_jax(shape):
    """Same shape, same bound: every draw lies within the JAX package's
    Glorot bound and comes close to it from inside."""
    got = tinit.GlorotUniform()(torch.Generator().manual_seed(0), shape,
                                torch.float32)
    want = np.asarray(jinit.GlorotUniform()(jax.random.PRNGKey(0), shape,
                                            jnp.float32))
    assert tuple(got.shape) == want.shape == shape
    assert got.dtype == torch.float32
    if len(shape) == 4:
        o, i, h, w = shape
        fan_in, fan_out = i * h * w, o * h * w
    elif len(shape) == 2:
        fan_in, fan_out = shape[1], shape[0]
    else:
        fan_in = fan_out = 1
    bound = np.sqrt(6.0 / (fan_in + fan_out))
    for v in (got.numpy(), want):
        assert np.abs(v).max() <= bound * (1 + 1e-6)
    if got.numel() >= 100:
        assert np.abs(got.numpy()).max() > 0.9 * bound


def test_other_initializers():
    g = torch.Generator().manual_seed(1)
    assert torch.count_nonzero(
        tinit.ZeroInitializer()(g, (3, 4), torch.float32)) == 0
    assert torch.all(tinit.ConstantInitializer(0.5)(g, (6,),
                                                    torch.float32) == 0.5)
    u = tinit.UniformInitializer(minv=-2.0, maxv=-1.0)(g, (500,),
                                                       torch.float32)
    assert float(u.min()) >= -2.0 and float(u.max()) <= -1.0
    z = tinit.NormInitializer(mean=3.0, stddev=0.5)(g, (4000,),
                                                    torch.float64)
    assert z.dtype == torch.float64
    assert abs(float(z.mean()) - 3.0) < 0.05
    assert abs(float(z.std()) - 0.5) < 0.05


def test_resolve_conv_layout():
    assert resolve_conv_layout("auto", torch.device("cpu")) == "nchw"
    assert resolve_conv_layout("auto", torch.device("cuda")) == "nhwc"
    assert resolve_conv_layout("NCHW", torch.device("cuda")) == "nchw"
    with pytest.raises(ValueError, match="conv_layout"):
        resolve_conv_layout("nwhc", torch.device("cpu"))


def test_dtype_policy():
    class _Op:
        parallel_config = None

    op = _Op()
    assert resolve_op_dtype(op, "bfloat16") == "bfloat16"
    op.parallel_config = ParallelConfig(precision="f32")
    assert resolve_op_dtype(op, "bfloat16") == "float32"
    ctx = OpContext(compute_dtype="bfloat16")
    assert cast_compute(torch.zeros(2), ctx).dtype == torch.bfloat16
    ints = torch.zeros(2, dtype=torch.int32)
    assert cast_compute(ints, ctx).dtype == torch.int32
