"""MoE, RMSNorm, the element-unary functions and Transpose in the port
against the JAX package, on the CPU in float32, after
``tests/test_moe.py:36-110``.

Ops are held one by one (the same inputs from numpy seeds through the
JAX op and the port's op: values and the gradient of a fixed weighted
sum), and through models built in both packages whose JAX weights are
carried into the port with ``interop.params_from_jax_numpy``.

Tolerances: elementwise functions and Transpose within 1e-6 (1e-5 for
the transcendental ones' gradients, whose float32 libraries differ by an
ulp or two); RMSNorm within 1e-5; MoE forwards, aux losses and gradients
within 1e-5 relative and 2e-6 absolute (float32 einsums sum in another
order; the routing itself, a top-k over well-separated probabilities,
is the same); trained models within the JAX tests' 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu import op as jop
from flexflow_tpu.ops import elementwise as jelem
from flexflow_tpu.ops import norm as jnorm
from flexflow_tpu.ops import tensor_ops as jtensor
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops import elementwise as telem
from flexflow_tpu_torch.ops import norm as tnorm
from flexflow_tpu_torch.ops import tensor_ops as ttensor
from flexflow_tpu_torch.tensor import Tensor as TTensor

RTOL = 1e-5
ATOL = 2e-6


def _new(pkg, batch):
    cfg = pkg.FFConfig(batch_size=batch, compute_dtype="float32")
    if pkg is ff:
        return ff.FFModel(cfg, mesh=MachineMesh({"n": 1}))
    return ft.FFModel(cfg, device="cpu")


def _weights(m):
    return {p.name: np.asarray(m.get_weights(p.name), np.float32)
            for p in m.parameters}


def _op_pair(jcls, tcls, shape, *args):
    return jcls("op", JTensor(shape), *args), tcls("op", TTensor(shape), *args)


def _jax_value_and_grad(op, x, w, params=None):
    params = params or {}
    ctx = jop.OpContext(training=False, compute_dtype="float32")

    def f(x, params):
        return jnp.sum(op.forward(params, [x], ctx)[0] * w)

    y = op.forward(params, [jnp.asarray(x)], ctx)[0]
    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)
    return np.asarray(y), np.asarray(gx), {k: np.asarray(v)
                                           for k, v in gp.items()}


def _port_value_and_grad(op, x, w, params=None):
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in (params or {}).items()}
    ctx = OpContext(compute_dtype="float32")
    xt = torch.tensor(x, requires_grad=True)
    y = op.forward(params, [xt], ctx)[0]
    torch.sum(y * torch.from_numpy(w)).backward()
    return (y.detach().numpy(), xt.grad.numpy(),
            {k: v.grad.numpy() for k, v in params.items()})


UNARY = ["exp", "log", "relu", "sigmoid", "tanh", "elu", "gelu", "silu",
         "identity", "rsqrt", "sqrt", "negative"]


@pytest.mark.parametrize("fn", UNARY)
def test_unary_function_matches_jax(fn):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    if fn in ("log", "rsqrt", "sqrt"):
        x = np.abs(x) + 0.1
    w = rng.standard_normal((4, 6)).astype(np.float32)
    jo, to = _op_pair(jelem.ElementUnary, telem.ElementUnary, (4, 6), fn)
    yj, gj, _ = _jax_value_and_grad(jo, x, w)
    yt, gt, _ = _port_value_and_grad(to, x, w)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-6)


def test_relu_gradient_at_nan_and_gelu_tanh_form():
    """ReLU: NaN stays NaN with gradient 0 there (jax.nn.relu); gelu is
    the tanh approximation (jax.nn.gelu's default), not the erf form."""
    x = np.array([[-1.0, 0.0, 2.0, np.nan]], np.float32)
    w = np.ones_like(x)
    jo, to = _op_pair(jelem.ElementUnary, telem.ElementUnary, (1, 4), "relu")
    yj, gj, _ = _jax_value_and_grad(jo, x, w)
    yt, gt, _ = _port_value_and_grad(to, x, w)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(gt, gj)
    assert np.isnan(yt[0, 3]) and gt[0, 3] == 0.0

    x = np.linspace(-3, 3, 13, dtype=np.float32)[None]
    _, to = _op_pair(jelem.ElementUnary, telem.ElementUnary, (1, 13), "gelu")
    y = to.forward({}, [torch.from_numpy(x)], OpContext())[0]
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert torch.equal(y, tanh) and not torch.allclose(y, erf, atol=1e-5)


@pytest.mark.parametrize("fn,scalar", [("scalar_mul", 2.5),
                                       ("scalar_add", -0.75),
                                       ("scalar_sub", 1.25),
                                       ("scalar_truediv", 3.0)])
def test_scalar_forms_match_jax(fn, scalar):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    jo, to = _op_pair(jelem.ElementUnary, telem.ElementUnary, (3, 5), fn,
                      scalar)
    yj, gj, _ = _jax_value_and_grad(jo, x, w)
    yt, gt, _ = _port_value_and_grad(to, x, w)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-6)


def test_unknown_unary_refused():
    with pytest.raises(ValueError, match="unknown unary"):
        telem.ElementUnary("u", TTensor((2, 2)), "cube")


@pytest.mark.parametrize("perm", [(1, 0, 2), (2, 0, 1), (0, 2, 1)])
def test_transpose_matches_jax(perm):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    jo, to = _op_pair(jtensor.Transpose, ttensor.Transpose, (2, 3, 4), perm)
    assert to.outputs[0].shape == jo.outputs[0].shape
    w = rng.standard_normal(jo.outputs[0].shape).astype(np.float32)
    yj, gj, _ = _jax_value_and_grad(jo, x, w)
    yt, gt, _ = _port_value_and_grad(to, x, w)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(gt, gj)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = (3.0 * rng.standard_normal((2, 5, 16))).astype(np.float32)
    w = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    jo, to = _op_pair(jnorm.RMSNorm, tnorm.RMSNorm, (2, 5, 16), 1e-6)
    assert [p.name for p in to.weights] == [p.name for p in jo.weights] \
        == ["op/scale"]
    p = {"op/scale": scale}
    yj, gj, pj = _jax_value_and_grad(jo, x, w, {"op/scale": jnp.asarray(scale)})
    yt, gt, pt = _port_value_and_grad(to, x, w, p)
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pt["op/scale"], pj["op/scale"], rtol=RTOL,
                               atol=1e-5)


# ----------------------------------------------------------------------
# MoE (tests/test_moe.py)
# ----------------------------------------------------------------------
def _moe_model(pkg, batch=16, s=8, d=32, E=4, k=2, cf=1.25, aux=1e-2,
               seed=0, d_ff=64):
    m = _new(pkg, batch)
    x = m.create_tensor((batch, s, d), name="x")
    t = m.moe(x, E, d_ff=d_ff, k=k, capacity_factor=cf,
              aux_loss_weight=aux, name="moe0")
    t = m.flat(t)
    t = m.dense(t, 8, name="head")
    m.compile(pkg.SGDOptimizer(lr=0.05),
              "sparse_categorical_crossentropy", ["accuracy"],
              final_tensor=t)
    m.init_layers(seed=seed)
    return m


def _moe_twins(**kw):
    ref = _moe_model(ff, **kw)
    port = _moe_model(ft, **kw)
    interop.params_from_jax_numpy(port, _weights(ref))
    return port, ref


def _moe_data(seed, batch=16, s=8, d=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, s, d)).astype(np.float32),
            rng.integers(0, 8, (batch, 1)).astype(np.int32))


def test_moe_parameters_match_the_jax_op():
    port, ref = _moe_twins()
    assert {p.name: p.shape for p in port.parameters} == \
        {p.name: p.shape for p in ref.parameters}
    moe = port.layers[0]
    assert moe.capacity == ref.layers[0].capacity == 80


def test_single_expert_equals_dense_ffn():
    rng = np.random.default_rng(0)
    batch, s, d = 4, 6, 16
    model = _new(ft, batch)
    x = model.create_tensor((batch, s, d), name="x")
    model.moe(x, num_experts=1, d_ff=32, k=1, capacity_factor=1.0,
              activation="relu", aux_loss_weight=0.0, name="moe0")
    model.compile(ft.SGDOptimizer(lr=0.1), "mean_squared_error", [],
                  final_tensor=model.layers[-1].outputs[0])
    model.init_layers(seed=3)
    xd = rng.standard_normal((batch, s, d)).astype(np.float32)
    out = model.predict(xd, batch_size=batch)
    w1 = model.get_weights("moe0/w_up")[0]      # (d_ff, d)
    b1 = model.get_weights("moe0/w_up_bias")[0]
    w2 = model.get_weights("moe0/w_down")[0]    # (d, d_ff)
    b2 = model.get_weights("moe0/w_down_bias")[0]
    ref = np.maximum(xd @ w1.T + b1, 0.0) @ w2.T + b2
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_capacity_drops_tokens():
    """A tiny capacity factor forces overflow: dropped tokens combine to
    zero, so the output changes, and the port drops the same tokens as
    the JAX op."""
    rng = np.random.default_rng(2)
    xd = rng.standard_normal((8, 4, 16)).astype(np.float32)
    outs = []
    for cf in (4.0, 0.25):
        jm = _new(ff, 8)
        pm = _new(ft, 8)
        for pkg, m in ((ff, jm), (ft, pm)):
            x = m.create_tensor((8, 4, 16), name="x")
            m.moe(x, num_experts=4, d_ff=32, k=1, capacity_factor=cf,
                  name="moe0")
            m.compile(pkg.SGDOptimizer(lr=0.1), "mean_squared_error", [],
                      final_tensor=m.layers[-1].outputs[0])
            m.init_layers(seed=5)
        interop.params_from_jax_numpy(pm, _weights(jm))
        want = np.asarray(jm.predict(xd, batch_size=8))
        got = pm.predict(xd, batch_size=8)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-4
    dropped = np.all(outs[1] == 0.0, axis=-1).sum()
    assert dropped > 0, "capacity 0.25 must drop some tokens"


def test_aux_loss_feeds_objective():
    xd, yd = _moe_data(3)
    m_aux, r_aux = _moe_twins(aux=0.5, seed=7)
    m_no = _moe_model(ft, aux=0.0, seed=7)
    interop.params_from_jax_numpy(m_no, _weights(r_aux))
    la = float(m_aux.train_batch(xd, yd))
    ln = float(m_no.train_batch(xd, yd))
    # the Switch aux loss is ~1 for a fresh router; weight 0.5 shows up
    assert la > ln + 0.1
    np.testing.assert_allclose(la, float(r_aux.train_batch(xd, yd)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_forward_and_gradients_match_jax(k):
    """Forward, the aux loss and every gradient of one training step,
    then 3 SGD steps."""
    xd, yd = _moe_data(1)
    port, ref = _moe_twins(k=k)
    want = np.asarray(ref.predict(xd))
    got = port.predict(xd)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    (lj, _), gj = ref._jit_grads(ref._params, (xd, yd), 0)
    lt, _, gt, _, _ = port._loss_and_grads(
        port._device_batch((xd, yd)), port._step_seed(0))
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    assert set(gt) == set(gj)
    for name, g in gj.items():
        np.testing.assert_allclose(gt[name].numpy(), np.asarray(g),
                                   rtol=RTOL, atol=ATOL, err_msg=name)

    aux = {}
    port._forward_values(port._params, port._device_batch((xd,)),
                         training=True, seed=0, aux_losses=aux)
    assert set(aux) == {"moe0"} and float(aux["moe0"]) > 0
    lj = [float(ref.train_batch(xd, yd)) for _ in range(3)]
    lt = [float(port.train_batch(xd, yd)) for _ in range(3)]
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    assert lt[-1] < lt[0]


def _stack(pkg, accum):
    """dense -> dense -> MoE -> RMSNorm -> head, with accumulation."""
    cfg = pkg.FFConfig(batch_size=8, compute_dtype="float32")
    cfg.gradient_accumulation_steps = accum
    m = (ff.FFModel(cfg, mesh=MachineMesh({"n": 1})) if pkg is ff
         else ft.FFModel(cfg, device="cpu"))
    x = m.create_tensor((8, 6, 16), name="x")
    t = m.dense(x, 24, activation="relu")
    t = m.dense(t, 16)
    t = m.moe(t, 4, d_ff=32, k=2, aux_loss_weight=0.05)
    t = m.rms_norm(t)
    t = m.flat(t)
    t = m.dense(t, 5)
    m.compile(pkg.SGDOptimizer(lr=0.05, momentum=0.9),
              "sparse_categorical_crossentropy", ["accuracy"],
              final_tensor=t)
    m.init_layers(seed=0)
    return m


@pytest.mark.parametrize("accum", [1, 2])
def test_dense_moe_rmsnorm_model_trains_like_jax(accum):
    """3 steps of a dense -> dense -> MoE -> RMSNorm model, the aux loss
    in the objective (scaled as the reduction asks under accumulation)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 6, 16)).astype(np.float32)
    y = rng.integers(0, 5, (8, 1)).astype(np.int32)
    ref = _stack(ff, accum)
    port = _stack(ft, accum)
    interop.params_from_jax_numpy(port, _weights(ref))
    lj = [float(ref.train_batch(x, y)) for _ in range(3)]
    lt = [float(port.train_batch(x, y)) for _ in range(3)]
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    for name, v in _weights(ref).items():
        np.testing.assert_allclose(port.get_weights(name), v, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _unary_chain(pkg):
    m = _new(pkg, 4)
    x = m.create_tensor((4, 3, 8), name="x")
    t = m.dense(x, 8)
    t = m.tanh(t)
    t = m.exp(t)
    t = m.sigmoid(t)
    t = m.elu(t)
    t = m.gelu(t)
    t = m.relu(t)
    t = m.identity(t)
    t = m.scalar_multiply(t, 1.5)
    t = m.rms_norm(t)
    t = m.transpose(t, (0, 2, 1))
    t = m.flat(t)
    t = m.dense(t, 3)
    m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
              [], final_tensor=t)
    m.init_layers(seed=0)
    return m


def test_unary_builders_match_jax():
    """The builders exp, relu, sigmoid, tanh, elu, gelu, identity,
    scalar_multiply, rms_norm and transpose name their ops as the JAX
    package does, and a chain of them predicts and trains the same."""
    ref, port = _unary_chain(ff), _unary_chain(ft)
    assert [op.name for op in port.layers] == [op.name for op in ref.layers]
    interop.params_from_jax_numpy(port, _weights(ref))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 3, 8)).astype(np.float32)
    y = rng.integers(0, 3, (4, 1)).astype(np.int32)
    np.testing.assert_allclose(port.predict(x), np.asarray(ref.predict(x)),
                               rtol=RTOL, atol=ATOL)
    for _ in range(2):
        np.testing.assert_allclose(float(port.train_batch(x, y)),
                                   float(ref.train_batch(x, y)),
                                   rtol=RTOL, atol=ATOL)
    for name, v in _weights(ref).items():
        np.testing.assert_allclose(port.get_weights(name), v, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
