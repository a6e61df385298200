"""The ResNet and InceptionV3 slice's ops against the JAX package's, on
the CPU, in float32 unless stated.

The same seeded numpy inputs go through each JAX op's ``forward`` and
its counterpart in ``flexflow_tpu_torch``:

- ``BatchNorm`` in training (batch statistics, with the running
  statistics handed back through ``OpContext.updates``) and in inference
  (running statistics): outputs within 1e-6, gradients with respect to
  x, scale and bias (autograd against ``jax.vjp``) within 1e-5 absolute
  and relative (scale's and bias's are sums over n*h*w terms), and the
  running statistics after two training steps within 1e-6.  A case shows
  that ``nn.BatchNorm2d``'s running-statistics update would fail that
  check: it weighs the batch by ``momentum`` where the JAX op weighs the
  running value, and keeps an unbiased running variance.
- ``Concat`` promotes mixed dtypes as ``jnp.result_type`` does, then
  concatenates: bit-equal.
- ``Pool2D``'s average pool at 3x3/s1/p1 (Inception's branch pools), at a
  global window (ResNet's and Inception's heads) and at a padding above
  half the window (which ``F.avg_pool2d`` refuses, so the op pads with
  zeros first): float32 within 1e-6.  In bfloat16, ``F.avg_pool2d`` sums
  in float32 where the JAX op sums in the input's dtype, rounding after
  each of the kh*kw adds: the port is held within one bf16 rounding
  (2^-8 relative) of the float64 mean, and the JAX op within
  2^-8 * sqrt(kh*kw) of the window's mean |x| of it, the size of the
  rounding walk of its adds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.conv import Pool2D as JaxPool2D
from flexflow_tpu.ops.norm import BatchNorm as JaxBatchNorm
from flexflow_tpu.ops.tensor_ops import Concat as JaxConcat
from flexflow_tpu.tensor import Tensor as JaxTensor
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops.conv import Pool2D
from flexflow_tpu_torch.ops.norm import BatchNorm
from flexflow_tpu_torch.ops.tensor_ops import Concat
from flexflow_tpu_torch.tensor import Tensor

F32_TOL = 1e-6
GRAD_TOL = 1e-5
BF16_ROUNDING = 2.0 ** -8
BN_SHAPES = [(4, 6, 5, 7), (2, 16, 3, 3)]


def _bn_params(op, seed):
    rng = np.random.default_rng(seed)
    c = op.w_scale.shape[0]
    return {op.w_scale.name: (1 + 0.3 * rng.standard_normal(c)),
            op.w_bias.name: 0.3 * rng.standard_normal(c),
            op.s_mean.name: 0.2 * rng.standard_normal(c),
            op.s_var.name: 1 + rng.random(c)}


def _bn_pair(shape, relu):
    jop = JaxBatchNorm("batchnorm", JaxTensor(shape, "float32"), relu)
    op = BatchNorm("batchnorm", Tensor(shape, "float32"), relu)
    assert [w.name for w in op.weights] == [w.name for w in jop.weights]
    assert [w.trainable for w in op.weights] == [True, True, False, False]
    return jop, op


def _torch_input(x, layout):
    t = torch.from_numpy(x)
    return (t.contiguous(memory_format=torch.channels_last)
            if layout == "nhwc" else t)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_batchnorm_training_matches_jax(shape, relu, layout):
    """Output, gradients and the two running statistics of a training
    step; then a second step from the updated statistics."""
    jop, op = _bn_pair(shape, relu)
    rng = np.random.default_rng(sum(shape))
    xs = [(2 * rng.standard_normal(shape) + 0.5).astype(np.float32)
          for _ in range(2)]
    params = {k: v.astype(np.float32)
              for k, v in _bn_params(jop, seed=1).items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    train = [jop.w_scale.name, jop.w_bias.name]
    for x in xs:
        def jfwd(x_, scale, bias):
            jctx = JaxOpContext(training=True, compute_dtype="float32")
            p = {**jparams, train[0]: scale, train[1]: bias}
            return jop.forward(p, [x_], jctx)[0], jctx.updates

        want, vjp, jupdates = jax.vjp(jfwd, jnp.asarray(x),
                                      jparams[train[0]], jparams[train[1]],
                                      has_aux=True)
        dy = rng.standard_normal(shape).astype(np.float32)
        want_grads = vjp(jnp.asarray(dy))
        ctx = OpContext(training=True, compute_dtype="float32",
                        conv_layout=layout)
        xt = _torch_input(x, layout).requires_grad_(True)
        leaves = {k: tparams[k].clone().requires_grad_(True) for k in train}
        (got,) = op.forward({**tparams, **leaves}, [xt], ctx)
        if layout == "nhwc":
            assert got.is_contiguous(memory_format=torch.channels_last)
        got_grads = torch.autograd.grad(got, [xt] + list(leaves.values()),
                                        torch.from_numpy(dy))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=F32_TOL)
        for g, w in zip(got_grads, want_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
        assert set(ctx.updates) == set(jupdates) == {
            jop.s_mean.name, jop.s_var.name}
        for k, v in jupdates.items():
            np.testing.assert_allclose(ctx.updates[k].detach().numpy(),
                                       np.asarray(v), rtol=0, atol=F32_TOL)
            jparams[k] = v
            tparams[k] = ctx.updates[k].detach()


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_batchnorm_inference_reads_the_running_statistics(shape, layout):
    jop, op = _bn_pair(shape, relu=True)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    params = {k: v.astype(np.float32)
              for k, v in _bn_params(jop, seed=2).items()}
    jctx = JaxOpContext(training=False, compute_dtype="float32")
    (want,) = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                          [jnp.asarray(x)], jctx)
    ctx = OpContext(training=False, compute_dtype="float32",
                    conv_layout=layout)
    (got,) = op.forward({k: torch.from_numpy(v) for k, v in params.items()},
                        [_torch_input(x, layout)], ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)
    assert ctx.updates == {} and jctx.updates == {}


def test_batchnorm_output_is_cast_to_the_compute_dtype():
    shape = (2, 4, 3, 3)
    _, op = _bn_pair(shape, relu=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).to(torch.bfloat16)
    params = {k: torch.from_numpy(v.astype(np.float32))
              for k, v in _bn_params(op, seed=3).items()}
    ctx = OpContext(training=True, compute_dtype="bfloat16")
    (y,) = op.forward(params, [x], ctx)
    assert y.dtype == torch.bfloat16
    # the statistics stay float32
    assert all(v.dtype == torch.float32 for v in ctx.updates.values())


def test_nn_batchnorm2d_running_update_would_fail():
    """The convention trap: ``nn.BatchNorm2d`` keeps ``(1 - momentum) *
    running + momentum * batch`` with the unbiased variance, where the
    JAX op keeps ``m * running + (1 - m) * batch`` with the population
    variance.  At the JAX op's momentum it fails the check above, and at
    the mirrored momentum its running variance still does."""
    shape = (4, 6, 5, 7)
    jop, _ = _bn_pair(shape, relu=False)
    x = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    params = {k: jnp.asarray(v.astype(np.float32))
              for k, v in _bn_params(jop, seed=4).items()}
    jctx = JaxOpContext(training=True, compute_dtype="float32")
    jop.forward(params, [jnp.asarray(x)], jctx)
    want_mean = np.asarray(jctx.updates[jop.s_mean.name])
    want_var = np.asarray(jctx.updates[jop.s_var.name])
    for momentum in (0.9, 1 - 0.9):
        bn = torch.nn.BatchNorm2d(shape[1], eps=1e-5, momentum=momentum)
        bn.running_mean.copy_(torch.tensor(
            np.asarray(params[jop.s_mean.name])))
        bn.running_var.copy_(torch.tensor(
            np.asarray(params[jop.s_var.name])))
        bn.train()
        bn(torch.from_numpy(x))
        got_var = bn.running_var.numpy()
        assert np.abs(got_var - want_var).max() > 100 * F32_TOL
        if momentum == 0.9:
            assert np.abs(bn.running_mean.numpy()
                          - want_mean).max() > 100 * F32_TOL


@pytest.mark.parametrize("dtypes,axis", [
    (("float32", "bfloat16", "float32"), 1),
    (("bfloat16", "float16"), 1),
    (("bfloat16", "bfloat16"), 0),
    (("float32", "bfloat16"), 3),
])
def test_concat_promotes_mixed_dtypes_like_jax(dtypes, axis):
    rng = np.random.default_rng(len(dtypes) + axis)
    shapes = []
    for i, _ in enumerate(dtypes):
        s = [2, 3, 4, 5]
        s[axis] = 2 + i
        shapes.append(tuple(s))
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jop = JaxConcat("concat", [JaxTensor(s, d) for s, d in zip(shapes,
                                                               dtypes)],
                    axis)
    op = Concat("concat", [Tensor(s, d) for s, d in zip(shapes, dtypes)],
                axis)
    assert op.outputs[0].shape == jop.outputs[0].shape
    (want,) = jop.forward({}, [jnp.asarray(x, getattr(jnp, d))
                               for x, d in zip(xs, dtypes)], JaxOpContext())
    (got,) = op.forward({}, [torch.from_numpy(x).to(getattr(torch, d))
                             for x, d in zip(xs, dtypes)], OpContext())
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_concat_keeps_channels_last_memory():
    shapes = [(2, 3, 4, 5), (2, 7, 4, 5)]
    xs = [torch.randn(s, generator=torch.Generator().manual_seed(i))
          .contiguous(memory_format=torch.channels_last)
          for i, s in enumerate(shapes)]
    op = Concat("concat", [Tensor(s) for s in shapes], 1)
    (y,) = op.forward({}, xs, OpContext(conv_layout="nhwc"))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, torch.cat([x.contiguous() for x in xs], 1))


AVG_CASES = [
    ((2, 6, 9, 9), (3, 3, 1, 1, 1, 1)),      # Inception's branch pools
    ((2, 8, 7, 7), (7, 7, 1, 1, 0, 0)),      # ResNet-50's head at 224
    ((2, 8, 8, 8), (8, 8, 1, 1, 0, 0)),      # InceptionV3's head at 299
    ((2, 4, 9, 10), (3, 3, 1, 2, 2, 2)),     # padding above half
    ((1, 3, 6, 7), (2, 3, 2, 1, 2, 0)),      # ... on one axis only
]


def _avg_pair(shape, geom, dtype="float32"):
    jop = JaxPool2D("pool2d", JaxTensor(shape, dtype), *geom,
                    pool_type="avg")
    op = Pool2D("pool2d", Tensor(shape, dtype), *geom, pool_type="avg")
    assert op.outputs[0].shape == jop.outputs[0].shape
    return jop, op


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("shape,geom", AVG_CASES)
def test_avg_pool_matches_jax_in_float32(shape, geom, layout):
    jop, op = _avg_pair(shape, geom)
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(op.outputs[0].shape).astype(np.float32)
    jctx = JaxOpContext(compute_dtype="float32", conv_layout=layout)
    want, vjp = jax.vjp(lambda a: jop.forward({}, [a], jctx)[0],
                        jnp.asarray(x))
    xt = _torch_input(x, layout).requires_grad_(True)
    (got,) = op.forward({}, [xt], OpContext(compute_dtype="float32",
                                            conv_layout=layout))
    assert tuple(got.shape) == op.outputs[0].shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=F32_TOL)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("shape,geom", AVG_CASES)
def test_avg_pool_matches_jax_in_bfloat16(shape, geom):
    jop, op = _avg_pair(shape, geom, "bfloat16")
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    (want,) = jop.forward({}, [jnp.asarray(x, jnp.bfloat16)],
                          JaxOpContext(compute_dtype="bfloat16"))
    (got,) = op.forward({}, [torch.from_numpy(x).to(torch.bfloat16)],
                        OpContext(compute_dtype="bfloat16"))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got = got.float().numpy()
    xb = torch.from_numpy(x).to(torch.bfloat16).double()
    kh, kw, sh, sw, ph, pw = geom
    pad = torch.nn.functional.pad
    exact = torch.nn.functional.avg_pool2d(
        pad(xb, (pw, pw, ph, ph)), (kh, kw), (sh, sw)).numpy()
    mean_abs = torch.nn.functional.avg_pool2d(
        pad(xb.abs(), (pw, pw, ph, ph)), (kh, kw), (sh, sw)).numpy()
    assert (np.abs(got - exact) <= BF16_ROUNDING * np.abs(exact)
            + 1e-7).all()
    walk = BF16_ROUNDING * np.sqrt(kh * kw) * mean_abs
    assert (np.abs(got - np.asarray(want, np.float64)) <= walk).all()
