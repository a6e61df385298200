"""ResNet-50 and InceptionV3 end to end: the port's builders against the
JAX package's, on the CPU, in float32.

Both packages build the same graph (ResNet-50 at 64 px with
``batch_norm`` off and on; a trimmed InceptionV3 with one module of
each kind; the full InceptionV3 at 75 px, the smallest input its trunk
takes).  The port draws its initial weights from its seed; they are set
into the JAX model, and the JAX model's weights are then carried into
the port with ``interop.params_from_jax_numpy``, which refuses unequal
parameter name sets.  The JAX model's own initial draw is replaced by
zeros for these tests: its initializers compile once per parameter
shape, about half a minute for InceptionV3 on one core, and every value
is overwritten anyway.

Tolerances:
- forwards: probabilities within 1e-5 (convolutions sum in another
  order than XLA's);
- ResNet-50 without BatchNorm and the trimmed InceptionV3: two SGD steps
  with momentum one after the other, losses within 1e-5 relative and
  every parameter within 1e-5;
- ResNet-50 with BatchNorm: each of two plain SGD steps starts from the
  reference's state (the port takes the JAX model's parameters and
  running statistics after the first step), and is held to the loss
  within 1e-4 relative, every parameter within 1% of the step's largest
  update, and the running statistics within 1e-3 of their largest
  value.  From random weights at batch 2 its float32 gradients sit near
  the edge of their precision: a few weight gradients (the stem's most)
  are near-cancelling sums through the 48 BatchNorms' backward passes,
  both packages' first steps lie about as far from a float64 run of the
  port as from each other, and two independent chains of steps drift
  apart through the parameters alone.  BatchNorm's own arithmetic is
  held tightly in ``test_torch_cnn_ops.py``.
The channels-last layout (the one the port runs on the card) is held
against nchw on the port's own weights: forwards within 1e-6 and one
training step within the tolerances above.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu import initializers as jinit
from flexflow_tpu.models import inception as jax_inception
from flexflow_tpu.models.resnet import build_resnet50 as jax_resnet50
from flexflow_tpu.parallel.mesh import MachineMesh
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.models import (build_inception_v3, build_resnet50,
                                       inception)

BS = 2
CLASSES = 10
FWD_TOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
BN_LOSS_RTOL = 1e-4
BN_STEP_SHARE = 1e-2
BN_STATS_RTOL = 1e-3
LAYOUT_FWD_TOL = 1e-6


@pytest.fixture
def quick_jax_init(monkeypatch):
    """The JAX initializers as host zeros (no compile per shape)."""
    def zeros(self, key, shape, dtype):
        return jnp.asarray(np.zeros(shape, dtype))

    def constant(self, key, shape, dtype):
        return jnp.asarray(np.full(shape, self.value, dtype))

    monkeypatch.setattr(jinit.GlorotUniform, "__call__", zeros)
    monkeypatch.setattr(jinit.ZeroInitializer, "__call__", zeros)
    monkeypatch.setattr(jinit.ConstantInitializer, "__call__", constant)


def _weights(m):
    return {p.name: np.asarray(m.get_weights(p.name), np.float32)
            for p in m.parameters}


def _data(image, steps=2, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BS, 3, image, image)).astype(np.float32),
             rng.integers(0, CLASSES, (BS, 1)).astype(np.int32))
            for _ in range(steps)]


def _twins(port_builder, jax_builder, optimizer, layout="auto"):
    """The port's model (weights from its seed) and the JAX model holding
    the same weights; the port then takes the JAX model's weights."""
    port, _, _ = port_builder(ft.FFConfig(batch_size=BS,
                                          compute_dtype="float32",
                                          conv_layout=layout), "cpu")
    port.compile(getattr(ft, optimizer[0])(**optimizer[1]))
    port.init_layers(seed=0)
    ref, _, _ = jax_builder(ff.FFConfig(batch_size=BS,
                                        compute_dtype="float32"))
    ref.compile(getattr(ff, optimizer[0])(**optimizer[1]),
                mesh=MachineMesh({"n": 1}))
    ref.init_layers(seed=0)
    for name, value in _weights(port).items():
        ref.set_weights(name, value)
    interop.params_from_jax_numpy(port, _weights(ref))
    return port, ref


def _resnet(batch_norm, image=64):
    return (lambda cfg, device: build_resnet50(
                cfg, CLASSES, image, batch_norm, device=device),
            lambda cfg: jax_resnet50(cfg, CLASSES, image, batch_norm))


def _trimmed_inception(ffmod, cfg, mods, device=None):
    """A narrow stem, then one module of each kind (A at 8 pool
    features, C at 8 channels), the global average pool and the head:
    every op kind and pool shape family of the trunk."""
    m = (ffmod.FFModel(cfg, device=device) if device
         else ffmod.FFModel(cfg))
    inp = m.create_tensor((BS, 3, 75, 75), name="input")
    t = m.conv2d(inp, 8, 3, 3, 2, 2, 0, 0, activation="relu")
    t = mods._inception_a(m, t, 8)
    t = mods._inception_b(m, t)
    t = mods._inception_c(m, t, 8)
    t = mods._inception_d(m, t)
    t = mods._inception_e(m, t)
    hw = t.shape[2]
    t = m.pool2d(t, hw, hw, 1, 1, 0, 0, pool_type="avg")
    t = m.flat(t)
    logits = m.dense(t, CLASSES)
    m.softmax(logits)
    return m, inp, logits


INCEPTION_TRIMMED = (
    lambda cfg, device: _trimmed_inception(ft, cfg, inception, device),
    lambda cfg: _trimmed_inception(ff, cfg, jax_inception))
SGD_MOMENTUM = ("SGDOptimizer", {"lr": 0.01, "momentum": 0.9})
SGD_PLAIN = ("SGDOptimizer", {"lr": 0.01})


@pytest.mark.parametrize("builders", [_resnet(False), INCEPTION_TRIMMED],
                         ids=["resnet50", "inception_trimmed"])
def test_forward_and_two_sgd_steps_match_jax(quick_jax_init, builders):
    port, ref = _twins(*builders, SGD_MOMENTUM)
    assert port.resolved_conv_layout == "nchw"
    steps = _data(64 if builders is not INCEPTION_TRIMMED else 75)
    x0 = steps[0][0]
    np.testing.assert_allclose(port.predict(x0), np.asarray(ref.predict(x0)),
                               rtol=0, atol=FWD_TOL)
    got = [float(port.train_batch(x, y)) for x, y in steps]
    want = [float(ref.train_batch(x, y)) for x, y in steps]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    w_port = _weights(port)
    for name, value in _weights(ref).items():
        np.testing.assert_allclose(w_port[name], value, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_resnet50_batchnorm_steps_match_jax(quick_jax_init):
    port, ref = _twins(*_resnet(True), SGD_PLAIN)
    names = {p.name: p for p in port.parameters}
    stats = sorted(k for k, p in names.items() if not p.trainable)
    assert len(stats) == 2 * 48 and all(
        k.split("/")[1] in ("running_mean", "running_var") for k in stats)
    steps = _data(64)
    x0 = steps[0][0]
    np.testing.assert_allclose(port.predict(x0), np.asarray(ref.predict(x0)),
                               rtol=0, atol=FWD_TOL)
    w0 = _weights(ref)
    for x, y in steps:
        before = _weights(ref)
        np.testing.assert_allclose(float(port.train_batch(x, y)),
                                   float(ref.train_batch(x, y)),
                                   rtol=BN_LOSS_RTOL)
        w_port, w_ref = _weights(port), _weights(ref)
        trainable = [k for k in w_ref if k not in stats]
        step = max(np.abs(w_ref[k] - before[k]).max() for k in trainable)
        drift = max(np.abs(w_port[k] - w_ref[k]).max() for k in trainable)
        assert 0 < drift <= BN_STEP_SHARE * step, (drift, step)
        for k in stats:
            np.testing.assert_allclose(
                w_port[k], w_ref[k], rtol=0,
                atol=BN_STATS_RTOL * np.abs(w_ref[k]).max(), err_msg=k)
        # the next step starts from the reference's state
        interop.params_from_jax_numpy(port, w_ref)
    # every running statistic moved, and inference reads them
    assert all(not np.array_equal(w_ref[k], w0[k]) for k in stats)
    np.testing.assert_allclose(port.predict(x0), np.asarray(ref.predict(x0)),
                               rtol=0, atol=FWD_TOL)


def test_full_inception_v3_forward_matches_jax(quick_jax_init):
    port, ref = _twins(
        lambda cfg, device: build_inception_v3(cfg, CLASSES, 75,
                                               device=device),
        lambda cfg: jax_inception.build_inception_v3(cfg, CLASSES, 75),
        SGD_MOMENTUM)
    names = [p.name for p in port.parameters]
    assert sum(n.endswith("/kernel") for n in names) == 94 + 1
    assert sum(type(op).__name__ == "Concat" for op in port.layers) == 11
    x = _data(75, steps=1)[0][0]
    got = port.predict(x)
    assert got.shape == (BS, CLASSES)
    np.testing.assert_allclose(got, np.asarray(ref.predict(x)), rtol=0,
                               atol=FWD_TOL)


@pytest.mark.parametrize("builders,image,batch_norm", [
    (_resnet(False), 64, False), (_resnet(True), 64, True),
    (INCEPTION_TRIMMED, 75, False)],
    ids=["resnet50", "resnet50_bn", "inception_trimmed"])
def test_channels_last_matches_nchw(builders, image, batch_norm):
    """The port's own weights through both layouts: the same forward and
    the same training step (the BatchNorm model's step to the drift
    bound above)."""
    x, y = _data(image, steps=1)[0]
    runs = {}
    for layout in ("nchw", "nhwc"):
        m, _, _ = builders[0](ft.FFConfig(batch_size=BS,
                                          compute_dtype="float32",
                                          conv_layout=layout), "cpu")
        m.compile(ft.SGDOptimizer(lr=0.01))
        m.init_layers(seed=0)
        assert m.resolved_conv_layout == layout
        w0 = _weights(m)
        probs = m.predict(x)
        loss = float(m.train_batch(x, y))
        runs[layout] = (probs, loss, _weights(m), w0)
    probs, loss, w, w0 = runs["nchw"]
    np.testing.assert_allclose(runs["nhwc"][0], probs, rtol=0,
                               atol=LAYOUT_FWD_TOL)
    np.testing.assert_allclose(runs["nhwc"][1], loss,
                               rtol=BN_LOSS_RTOL if batch_norm
                               else LOSS_RTOL)
    if batch_norm:
        step = max(np.abs(w[k] - w0[k]).max() for k in w
                   if "running" not in k)
        drift = max(np.abs(runs["nhwc"][2][k] - w[k]).max() for k in w
                    if "running" not in k)
        assert drift <= BN_STEP_SHARE * step, (drift, step)
        return
    for name, value in w.items():
        np.testing.assert_allclose(runs["nhwc"][2][name], value, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_builders_take_the_jax_builders_arguments():
    """Parameter names and shapes equal the JAX builders' at the default
    widths (no JAX weights are made)."""
    for port_fn, jax_fn in (
            (lambda c: build_resnet50(c, 1000, 224, True, device="cpu"),
             lambda c: jax_resnet50(c, 1000, 224, True)),
            (lambda c: build_inception_v3(c, 1000, device="cpu"),
             lambda c: jax_inception.build_inception_v3(c, 1000))):
        port, _, logits = port_fn(ft.FFConfig(batch_size=4))
        ref, _, jlogits = jax_fn(ff.FFConfig(batch_size=4))
        assert [(p.name, p.shape, p.trainable) for p in port.parameters] == \
            [(p.name, tuple(p.shape), p.trainable) for p in ref.parameters]
        assert logits.shape == jlogits.shape == (4, 1000)
        assert [op.name for op in port.layers] == [op.name
                                                   for op in ref.layers]


def _small_bn_net(device="cpu"):
    cfg = ft.FFConfig(batch_size=BS, compute_dtype="float32")
    m = ft.FFModel(cfg, device=device)
    inp = m.create_tensor((BS, 3, 12, 12), name="input")
    t = m.conv2d(inp, 6, 3, 3, 1, 1, 1, 1)
    t = m.batch_norm(t)
    t = m.pool2d(t, 3, 3, 2, 2, 1, 1)
    t = m.batch_norm(t, relu=False)
    t = m.flat(t)
    m.softmax(m.dense(t, CLASSES))
    m.compile(ft.SGDOptimizer(lr=0.01, momentum=0.9))
    m.init_layers(seed=0)
    return m


def test_imperative_loop_applies_the_running_statistics_in_backward():
    """``backward()`` applies BatchNorm's running statistics at once, as
    the JAX package's does, and ``update()`` leaves them alone: the
    imperative loop ends where ``train_batch`` does."""
    x, y = _data(12, steps=1)[0]
    a, b = _small_bn_net(), _small_bn_net()
    names = ["batchnorm/running_mean", "batchnorm/running_var",
             "batchnorm_1/running_mean", "batchnorm_1/running_var"]
    assert [p.name for p in a.parameters if not p.trainable] == names
    start = _weights(b)
    a.train_batch(x, y)
    b.set_batch(x, y)
    b.zero_gradients()
    b.backward()
    after_backward = _weights(b)
    for k in names:
        assert not np.array_equal(after_backward[k], start[k]), k
    b.update()
    w_a, w_b = _weights(a), _weights(b)
    for k in names:
        np.testing.assert_array_equal(w_b[k], after_backward[k])
    for k, v in w_a.items():
        np.testing.assert_array_equal(w_b[k], v, err_msg=k)
    # inference reads the running statistics, and only training moves them
    probs = b.predict(x)
    assert _weights(b)[names[0]].tolist() == w_b[names[0]].tolist()
    b.set_weights(names[1], np.full(6, 4.0, np.float32))
    assert not np.allclose(b.predict(x), probs)
