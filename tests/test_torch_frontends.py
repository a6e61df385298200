"""The port's frontends against the JAX package's, on the CPU:
``flexflow_tpu_torch.keras`` against ``flexflow_tpu.keras`` and
``flexflow_tpu_torch.nn_compat`` against ``flexflow_tpu.torch``, the
thirteen cases of ``tests/test_frontends.py`` each built in both packages.

Both sides build the same graph in float32 (the JAX one on a one-device
mesh).  Keras names default layers from a per-class counter, and the two
packages' classes count apart, so a layer's name depends on what the
process built before: the JAX model's weights are carried into the port
by graph order (the two ``parameters`` lists, position by position, the
shapes and the op types checked equal) through
``interop.params_from_jax_numpy``.  Then each of 3 steps
(``set_batch``, ``backward``, ``update``) must give the same loss, the
same gradients, the same updated parameters and the same ``predict``
outputs within 1e-5 relative (of each value, or of the tensor's largest
magnitude where a subtraction cancels), and the ``fit`` runs with their
callbacks the same learning rates, epochs and parameters.

Also here: weights files written by keras ``save_weights`` in either
package load in the other, the synthetic ``cifar10``/``mnist``/
``reuters`` arrays are bit-equal across the packages, the data loaders
and the keras preprocessing helpers agree, and without a card and
without a device the frontends fail loudly instead of running on the
CPU.
"""

import os

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu import keras as jk
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu_torch import keras as pk
from flexflow_tpu_torch.interop import params_from_jax_numpy

RTOL = 1e-5
ATOL = 1e-7
STEPS = 3
SCCE = "sparse_categorical_crossentropy"


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card unless the process has
    another default device (the runner's ``--device cpu``)."""
    ft.set_default_device("cpu")
    yield
    ft.set_default_device(None)


def _learnable_data(n=256, shape=(12,), classes=4, seed=0):
    """Labels linearly decodable from inputs so tiny models hit >90%
    (``tests/test_frontends.py``'s data)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, (n,)).astype(np.int32)
    x = rng.standard_normal((n,) + shape).astype(np.float32) * 0.05
    flat = x.reshape(n, -1)
    flat[np.arange(n), y % flat.shape[1]] += 2.0
    return x.reshape((n,) + shape), y.reshape(n, 1)


def _close(got, want, what):
    """Within RTOL of each value and of the tensor's largest magnitude
    (a difference of two branches cancels to values far under the
    rounding of its terms)."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=RTOL, atol=max(ATOL, RTOL * scale),
                               err_msg=what)


def _names(jcore, pcore):
    """{port parameter name: JAX parameter name}, by graph order; the
    two graphs must hold the same ops and parameter shapes."""
    assert ([op.op_type.value for op in jcore.layers]
            == [op.op_type.value for op in pcore.layers])
    jp, pp = jcore.parameters, pcore.parameters
    assert ([tuple(p.shape) for p in jp]
            == [tuple(p.shape) for p in pp]), (jp, pp)
    return {q.name: p.name for p, q in zip(jp, pp)}


def _carry(jcore, pcore):
    """The JAX model's weights into the port's, by graph order."""
    names = _names(jcore, pcore)
    params_from_jax_numpy(pcore, {
        q: np.asarray(jcore.get_weights(j), np.float32)
        for q, j in names.items()})
    return names


def _cfg(pkg, batch):
    return pkg.FFConfig(batch_size=batch, compute_dtype="float32")


def _compile(model, pkg, opt, loss, metrics, batch):
    if pkg is ff:
        model.compile(opt, loss=loss, metrics=metrics, config=_cfg(ff, batch),
                      mesh=MachineMesh({"n": 1}))
    else:
        model.compile(opt, loss=loss, metrics=metrics, config=_cfg(ft, batch))
    return model


def _pair(build, opt, loss=SCCE, metrics=("accuracy",), batch=32):
    """``build(keras)`` in both packages, compiled, the port carrying the
    JAX model's weights.  ``opt(keras)`` makes each side's optimizer."""
    jm = _compile(build(jk), ff, opt(jk), loss, list(metrics), batch)
    pm = _compile(build(pk), ft, opt(pk), loss, list(metrics), batch)
    names = _carry(jm.ffmodel, pm.ffmodel)
    return jm, pm, names


def _params(core):
    return {p.name: np.asarray(core.get_weights(p.name), np.float32)
            for p in core.parameters}


def _hold_params(jcore, pcore, names, what):
    jw, pw = _params(jcore), _params(pcore)
    for q, j in names.items():
        _close(pw[q], jw[j], f"{what}: {q}")


def _grad(g):
    if isinstance(g, torch.Tensor):
        return g.detach().cpu().numpy()
    return np.asarray(g)


def _steps(jcore, pcore, names, batches, xs_pred):
    """Each batch: loss, gradients, updated parameters and predict
    outputs within 1e-5 relative."""
    for i, arrays in enumerate(batches):
        jcore.set_batch(*arrays)
        pcore.set_batch(*arrays)
        jl, pl = float(jcore.backward()), float(pcore.backward())
        _close(pl, jl, f"step {i} loss")
        jg, pg = jcore._cached_grads, pcore._cached_grads
        assert set(pg) == set(names) and set(jg) == set(names.values())
        for q, j in names.items():
            _close(_grad(pg[q]), _grad(jg[j]), f"step {i} grad {q}")
        jcore.update()
        pcore.update()
        _hold_params(jcore, pcore, names, f"step {i}")
        _close(pcore.predict(xs_pred), jcore.predict(xs_pred),
               f"step {i} predict")


def _batches(x, y, bs, n=STEPS):
    xs = x if isinstance(x, (list, tuple)) else [x]
    return [tuple(a[i * bs:(i + 1) * bs] for a in xs) + (y[i * bs:(i + 1)
                                                           * bs],)
            for i in range(n)]


def _mlp(K):
    return K.Sequential([
        K.Dense(64, activation="relu", input_shape=(12,)),
        K.Dense(32, activation="relu"),
        K.Dense(4),
        K.Activation("softmax"),
    ])


def test_sequential_mlp_with_verify_metrics():
    """seq_mnist_mlp: Sequential + fit with VerifyMetrics, 3 steps then
    the 6-epoch fit of the JAX test, in both packages."""
    x, y = _learnable_data()
    jm, pm, names = _pair(_mlp, lambda K: K.SGD(learning_rate=0.2))
    _steps(jm.ffmodel, pm.ffmodel, names, _batches(x, y, 32), x[:32])
    pms = [m.fit(x, y, epochs=6, verbose=0,
                 callbacks=[K.VerifyMetrics(K.ModelAccuracy.MNIST_MLP)])
           for m, K in ((jm, jk), (pm, pk))]
    _close(pms[1].accuracy, pms[0].accuracy, "fit accuracy")
    _hold_params(jm.ffmodel, pm.ffmodel, names, "after fit")
    (jl, jpm), (ql, qpm) = jm.evaluate(x, y), pm.evaluate(x, y)
    _close(ql, jl, "evaluate loss")
    assert qpm.accuracy >= 0.9 and qpm.accuracy == jpm.accuracy


def _cnn(K):
    inp = K.Input((3, 12, 12))
    t = K.Conv2D(8, (3, 3), strides=(1, 1), padding="same",
                 activation="relu")(inp)
    t = K.MaxPooling2D((2, 2))(t)
    t = K.Flatten()(t)
    t = K.Dense(32, activation="relu")(t)
    out = K.Activation("softmax")(K.Dense(4)(t))
    return K.Model(inp, out)


def test_functional_cnn_trains():
    """func_cifar10_cnn: conv/pool stack through the functional API."""
    x, y = _learnable_data(n=128, shape=(3, 12, 12), classes=4, seed=1)
    jm, pm, names = _pair(_cnn, lambda K: K.SGD(learning_rate=0.1))
    assert [op.op_type.value for op in pm.ffmodel.layers][:2] == [
        "conv2d", "pool2d"]
    _steps(jm.ffmodel, pm.ffmodel, names, _batches(x, y, 32), x[:32])
    firsts = [m.fit(x, y, epochs=1, verbose=0).accuracy for m in (jm, pm)]
    lasts = [m.fit(x, y, epochs=5, verbose=0).accuracy for m in (jm, pm)]
    _close(firsts[1], firsts[0], "first epoch accuracy")
    _close(lasts[1], lasts[0], "last epoch accuracy")
    assert lasts[1] > firsts[1]
    _hold_params(jm.ffmodel, pm.ffmodel, names, "after fit")


def _concat(K):
    inp = K.Input((8,))
    a = K.Dense(16, activation="relu")(inp)
    b = K.Dense(16, activation="tanh")(inp)
    t = K.Concatenate(axis=1)([a, b])
    return K.Model(inp, K.Activation("softmax")(K.Dense(4)(t)))


def test_functional_concat_model():
    """Concat functional coverage (func_*_concat examples), Adam."""
    x, y = _learnable_data(n=128, shape=(8,), classes=4, seed=2)
    jm, pm, names = _pair(_concat, lambda K: K.Adam(learning_rate=0.01))
    _steps(jm.ffmodel, pm.ffmodel, names, _batches(x, y, 32), x[:32])
    accs = []
    for m in (jm, pm):
        m.fit(x, y, epochs=3, verbose=0)
        accs.append(m.get_perf_metrics().accuracy)
    _close(accs[1], accs[0], "accuracy")
    assert accs[1] > 0.5
    _hold_params(jm.ffmodel, pm.ffmodel, names, "after fit")


def _named_mlp(K):
    return K.Sequential([K.Dense(8, activation="relu", input_shape=(6,),
                                 name="d0"),
                         K.Dense(3, name="d1"), K.Activation("softmax")])


def test_keras_layer_weight_access():
    """get_layer().get_weights()/set_weights in both packages."""
    x, _ = _learnable_data(n=64, shape=(6,), classes=3, seed=3)
    jm, pm, _ = _pair(_named_mlp, lambda K: K.SGD())
    for m in (jm, pm):
        k, b = m.get_layer("d0").get_weights()
        assert k.shape == (8, 6) and b.shape == (8,)
        m.get_layer("d0").set_weights([np.ones_like(k), b])
        np.testing.assert_allclose(m.get_layer("d0").get_weights()[0], 1.0)
    assert [layer.name for layer in pm.layers] == ["d0", "d1",
                                                   pm.layers[2].name]
    _close(pm.predict(x[:32]), jm.predict(x[:32]), "predict after set")


@pytest.mark.parametrize("name", ["mnist", "cifar10", "reuters"])
def test_keras_dataset_fallbacks(tmp_path, name):
    """The synthetic fallback arrays are the JAX package's, bit for bit
    (no cached file at the path: nothing is downloaded)."""
    path = str(tmp_path / "absent")
    want = getattr(jk.datasets, name).load_data(path=path)
    got = getattr(pk.datasets, name).load_data(path=path)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gx.shape == wx.shape
        if gx.dtype == object:
            assert [list(r) for r in gx] == [list(r) for r in wx]
        else:
            np.testing.assert_array_equal(gx, wx)
        assert gy.dtype == wy.dtype
        np.testing.assert_array_equal(gy, wy)
    if name == "mnist":
        assert got[0][0].shape[1:] == (28, 28)
    if name == "cifar10":
        assert got[0][0].shape[1:] == (3, 32, 32)


def _dense_softmax(K):
    return K.Sequential([K.Dense(64, activation="relu", input_shape=(12,)),
                         K.Dense(4), K.Activation("softmax")])


def _spied_scheduler(K, model, schedule):
    """A LearningRateScheduler that records the core optimizer's rate
    after it ran."""
    sched = K.LearningRateScheduler(schedule)
    lrs = []
    orig = sched.on_epoch_begin

    def spy(epoch, logs=None):
        orig(epoch, logs)
        opt = model.ffmodel.optimizer
        lrs.append(getattr(opt, "lr", None) or opt.alpha)

    sched.on_epoch_begin = spy
    return sched, lrs


def test_lr_scheduler_and_early_stop_callbacks():
    """LearningRateScheduler with SGD (the next step reads the new rate)
    and EpochVerifyMetrics early-stopping the epoch loop: the same rates,
    the same stop and the same parameters in both packages."""
    x, y = _learnable_data()
    jm, pm, names = _pair(_dense_softmax,
                          lambda K: K.SGD(learning_rate=0.05))
    runs = []
    for m, K in ((jm, jk), (pm, pk)):
        sched, lrs = _spied_scheduler(K, m, lambda e: 0.2 / (e + 1))
        stopper = K.EpochVerifyMetrics(K.ModelAccuracy.MNIST_MLP)
        m.fit(x, y, epochs=20, verbose=0, callbacks=[sched, stopper])
        runs.append((lrs, stopper.reached))
    (jlrs, jreached), (plrs, preached) = runs
    assert plrs == jlrs and plrs[0] == pytest.approx(0.2)
    assert preached and jreached and len(plrs) < 20
    _hold_params(jm.ffmodel, pm.ffmodel, names, "after fit")


def test_lr_scheduler_works_with_adam():
    """Adam stores its rate as alpha; the scheduler's new rate reaches
    the next step: the parameters after each epoch equal the JAX
    package's."""
    x, y = _learnable_data(n=64)

    def build(K):
        return K.Sequential([K.Dense(4, input_shape=(12,)),
                             K.Activation("softmax")])

    jm, pm, names = _pair(build, lambda K: K.Adam(learning_rate=0.01))
    for epoch in range(2):
        for m, K in ((jm, jk), (pm, pk)):
            sched = K.LearningRateScheduler(
                lambda e, epoch=epoch: 0.01 / (e + epoch + 1))
            m.fit(x, y, epochs=1, verbose=0, callbacks=[sched])
        _hold_params(jm.ffmodel, pm.ffmodel, names, f"epoch {epoch}")
    assert pm.ffmodel.optimizer.alpha == pytest.approx(0.005)
    assert jm.ffmodel.optimizer.alpha == pm.ffmodel.optimizer.alpha


def test_early_stopping_restores_the_best_weights():
    """EarlyStopping on val_loss with restore_best_weights: the same
    stop, best value and restored parameters as the JAX package's."""
    x, y = _learnable_data(n=96, seed=5)
    xv, yv = _learnable_data(n=32, seed=6)
    jm, pm, names = _pair(_dense_softmax, lambda K: K.SGD(learning_rate=2.0))
    stops = []
    for m, K in ((jm, jk), (pm, pk)):
        es = K.EarlyStopping(monitor="val_loss", patience=1,
                             restore_best_weights=True)
        m.fit(x, y, epochs=8, verbose=0, callbacks=[es],
              validation_data=(xv, yv))
        stops.append((es.best, es.wait, es.stop_training))
    _close(stops[1][0], stops[0][0], "best val_loss")
    assert stops[1][1:] == stops[0][1:]
    _hold_params(jm.ffmodel, pm.ffmodel, names, "restored")


def test_load_numpy_dataset_keras_layout(tmp_path):
    """A keras-style archive returns the TRAIN split, as the JAX loader
    does; a corrupt archive raises CorruptNpzError."""
    from flexflow_tpu.data import load_numpy_dataset as jax_load
    from flexflow_tpu_torch.data import load_numpy_dataset
    from flexflow_tpu_torch.resilience import CorruptNpzError
    path = os.path.join(tmp_path, "mnist.npz")
    np.savez(path,
             x_train=np.zeros((60, 4)), y_train=np.ones((60,)),
             x_test=np.zeros((10, 4)), y_test=np.zeros((10,)))
    xs, y = load_numpy_dataset(path)
    wxs, wy = jax_load(path)
    assert len(xs) == 1 and xs[0].shape == (60, 4)
    assert y.shape == (60,) and y[0] == 1.0
    np.testing.assert_array_equal(xs[0], wxs[0])
    np.testing.assert_array_equal(y, wy)
    plain = os.path.join(tmp_path, "plain.npz")
    np.savez(plain, x0=np.arange(6.0).reshape(3, 2), x1=np.ones((3, 1)),
             label=np.arange(3))
    for a, b in zip(load_numpy_dataset(plain)[0], jax_load(plain)[0]):
        np.testing.assert_array_equal(a, b)
    bad = os.path.join(tmp_path, "bad.npz")
    with open(path, "rb") as f:
        blob = f.read()
    with open(bad, "wb") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(CorruptNpzError, match="bad.npz"):
        load_numpy_dataset(bad)


def test_data_loaders_feed_the_model():
    """SingleDataLoader and DataLoader batch as the JAX package's do;
    ``next_batch`` loads the port's model, whose forward equals the JAX
    model's on the same batch, and wraps past the end."""
    from flexflow_tpu.data import DataLoader as JaxLoader
    from flexflow_tpu_torch.data import DataLoader, SingleDataLoader
    x, y = _learnable_data(n=80)
    jm, pm, _ = _pair(_mlp, lambda K: K.SGD())
    single = SingleDataLoader(pm.ffmodel, None, x)
    assert single.batch_size == 32
    np.testing.assert_array_equal(single.next_batch(), x[:32])
    np.testing.assert_array_equal(single.next_batch(), x[32:64])
    single.reset()
    np.testing.assert_array_equal(single.next_batch(), x[:32])
    pl, jl = DataLoader(pm.ffmodel, [x], y), JaxLoader(jm.ffmodel, [x], y)
    for it in range(3):   # the third batch starts over at row 0
        pl.next_batch()
        jl.next_batch()
        assert pl.next_index == jl.next_index
        _close(pm.ffmodel.forward(), jm.ffmodel.forward(), f"batch {it}")
    assert pl.next_index == 32


def _two_out(K):
    d = K.Dense(4)
    a, b = K.Input((8,)), K.Input((8,))
    return K.Model([a, b], [d(a), d(b)])


def test_shared_layer_two_outputs_compiles():
    """One layer called on two inputs: one kernel in both packages."""
    jm, pm, names = _pair(_two_out, lambda K: K.SGD(), batch=8)
    for m in (jm, pm):
        kernels = [p for p in m.ffmodel.parameters
                   if p.name.endswith("kernel")]
        assert len(kernels) == 1
    assert len(names) == 2


def test_frontends_use_cli_default_config():
    """keras ``compile`` and ``nn_compat.Module`` without a config read
    the process default (a fresh copy per model), and ``FFModel()``
    too: the runner's flags reach a script that passes no config."""
    from flexflow_tpu_torch.nn_compat import nn
    cfg = ft.FFConfig(batch_size=48, compute_dtype="float32")
    ft.set_default_config(cfg)
    try:
        m = pk.Sequential([pk.Dense(4, input_shape=(8,)),
                           pk.Activation("softmax")])
        m.compile(pk.SGD(), loss=SCCE, metrics=["accuracy"])
        assert m.ffconfig.batch_size == 48
        assert m.ffconfig is not cfg
        assert m.ffmodel.input_tensors[0].shape == (48, 8)
        mod = nn.Module()
        assert mod.ffconfig.batch_size == 48 and mod.ffconfig is not cfg
        core = ft.FFModel()
        assert core.config.batch_size == 48 and core.config is not cfg
    finally:
        ft.set_default_config(None)
    assert ft.FFModel().config.batch_size == 64


def test_default_device_reaches_the_frontends():
    """The default device installed (the runner's --device cpu) reaches
    keras and nn_compat models and FFModel; None puts the card back."""
    from flexflow_tpu_torch.nn_compat import nn
    assert ft.get_default_device() == "cpu"
    m = pk.Sequential([pk.Dense(4, input_shape=(8,))])
    m.compile(pk.SGD(), loss="mse", config=_cfg(ft, 8))
    assert m.ffmodel.device.type == "cpu"
    assert nn.Module(_cfg(ft, 8)).ffmodel.device.type == "cpu"
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        ft.set_default_device("tpu")
    assert ft.get_default_device() == "cpu"


def test_frontends_without_a_card_fail_loudly():
    """No card, no device and no default device: keras ``compile`` and
    ``nn_compat.Module`` raise ``default_device()``'s RuntimeError, never
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from flexflow_tpu_torch.nn_compat import nn
    ft.set_default_device(None)
    m = pk.Sequential([pk.Dense(4, input_shape=(8,))])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.compile(pk.SGD(), loss="mse", config=_cfg(ft, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nn.Module(_cfg(ft, 8))


def _net_class(nn):
    class Net(nn.Module):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.conv1 = nn.Conv2d(3, 8, kernel_size=3, stride=1, padding=1)
            self.relu1 = nn.ReLU()
            self.pool1 = nn.MaxPool2d(kernel_size=2, stride=2)
            self.flat = nn.Flatten()
            self.fc1 = nn.Linear(8 * 6 * 6, 32)
            self.relu2 = nn.ReLU()
            self.fc2 = nn.Linear(32, 4)
            self.softmax = nn.Softmax()

        def forward(self, x):
            x = self.pool1(self.relu1(self.conv1(x)))
            x = self.relu2(self.fc1(self.flat(x)))
            return self.softmax(self.fc2(x))

    return Net


def test_torch_module_alexnet_style():
    """alexnet_torch.py's pattern through the nn_compat shim against the
    JAX package's torch.nn shim: the same op names, then 3 steps and 5
    ``train_batch`` losses."""
    from flexflow_tpu.torch import nn as jnn
    from flexflow_tpu_torch.nn_compat import nn as pnn

    x, y = _learnable_data(n=96, shape=(3, 12, 12), classes=4, seed=4)
    jnet = _net_class(jnn)(_cfg(ff, 32))
    pnet = _net_class(pnn)(_cfg(ft, 32))
    assert not isinstance(pnet, torch.nn.Module)
    for net in (jnet, pnet):
        net(net.create_input((32, 3, 12, 12)))
    jnet.compile(ff.SGDOptimizer(lr=0.1), SCCE, ["accuracy"],
                 mesh=MachineMesh({"n": 1}))
    pnet.compile(ft.SGDOptimizer(lr=0.1), SCCE, ["accuracy"])
    assert ([op.name for op in pnet.ffmodel.layers]
            == [op.name for op in jnet.ffmodel.layers])
    names = _carry(jnet.ffmodel, pnet.ffmodel)
    assert all(q == j for q, j in names.items())
    _steps(jnet.ffmodel, pnet.ffmodel, names,
           _batches(x, y, 32, n=STEPS), x[:32])
    losses = [[float(n.ffmodel.train_batch(x[:32], y[:32]))
               for _ in range(5)] for n in (jnet, pnet)]
    _close(losses[1], losses[0], "train_batch losses")
    assert losses[1][-1] < losses[1][0]
    preds = pnet.predict(x[:32])
    assert preds.shape == (32, 4)
    _close(preds, jnet.predict(x[:32]), "predict")
    assert [p.name for p in pnet.parameters()] == [
        p.name for p in jnet.parameters()]


def _shared_subtract(K):
    a, b = K.Input((16,)), K.Input((16,))
    shared = K.Dense(8, use_bias=False, name="shared_fc")
    return K.Model([a, b], K.Subtract()([shared(a), shared(b)]))


def test_keras_shared_layer_reuse():
    """One Layer called twice shares ONE weight set: one kernel, its
    gradient the sum of both call sites' (equal to the JAX package's),
    identical inputs give exactly zero."""
    rng = np.random.default_rng(0)
    jm, pm, names = _pair(_shared_subtract,
                          lambda K: K.SGD(learning_rate=0.05),
                          loss="mean_squared_error", metrics=(), batch=8)
    core = pm.ffmodel
    assert [p.name for p in core.parameters] == ["shared_fc/kernel"]
    assert core.get_parameter_by_name("kernel").name == "shared_fc/kernel"
    assert core.get_parameter_by_name("shared_fc/kernel") is \
        core.parameters[0]
    assert core.get_parameter_by_name("bias") is None
    x = rng.standard_normal((8, 16)).astype(np.float32)
    np.testing.assert_allclose(core.predict([x, x], batch_size=8), 0.0,
                               atol=1e-6)
    batches = [(rng.standard_normal((8, 16)).astype(np.float32),
                rng.standard_normal((8, 16)).astype(np.float32),
                rng.standard_normal((8, 8)).astype(np.float32))
               for _ in range(STEPS)]
    before = core.get_weights("shared_fc/kernel")
    _steps(jm.ffmodel, core, names, batches, [x, x[::-1].copy()])
    assert np.abs(core.get_weights("shared_fc/kernel") - before).max() > 0


def _towers(K):
    inner_in = K.Input((16,))
    tower = K.Model(inner_in, K.Dense(8, use_bias=False,
                                      name="tower_fc")(inner_in))
    head = K.Sequential([K.Dense(4, use_bias=False, name="head_fc")])
    a, b = K.Input((16,)), K.Input((16,))
    return K.Model([a, b], K.Subtract()([head(tower(a)), head(tower(b))]))


def test_model_as_layer_shares_weights():
    """A functional Model and a Sequential called as layers on two
    inputs replay their graphs with one shared weight set each."""
    rng = np.random.default_rng(0)
    jm, pm, names = _pair(_towers, lambda K: K.SGD(learning_rate=0.05),
                          loss="mean_squared_error", metrics=(), batch=8)
    assert sorted(p.name for p in pm.ffmodel.parameters) == [
        "head_fc/kernel", "tower_fc/kernel"]
    x = rng.standard_normal((8, 16)).astype(np.float32)
    np.testing.assert_allclose(pm.ffmodel.predict([x, x], batch_size=8),
                               0.0, atol=1e-6)
    batches = [(rng.standard_normal((8, 16)).astype(np.float32),
                rng.standard_normal((8, 16)).astype(np.float32),
                rng.standard_normal((8, 4)).astype(np.float32))
               for _ in range(STEPS)]
    _steps(jm.ffmodel, pm.ffmodel, names, batches, [x, x[::-1].copy()])


def test_summary_text_equals_the_jax_package():
    """``summary()`` (keras and core) prints the JAX package's table
    (every layer named, so the text does not depend on the counters)."""
    def build(K):
        return K.Sequential([K.Dense(8, activation="relu",
                                     input_shape=(6,), name="s0"),
                             K.Dense(3, name="s1"),
                             K.Activation("softmax", name="s2")])

    jm, pm, _ = _pair(build, lambda K: K.SGD())
    assert pm.summary() == jm.summary()
    assert pm.summary().splitlines()[-1] == (
        f"total parameters: {pm.ffmodel.num_parameters}")
    assert pk.Sequential([]).summary() == "Sequential"


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_weights_files_load_across_packages(tmp_path, direction):
    """keras ``save_weights`` writes ``<index>:<name>`` arrays in graph
    order in both packages; each loads the other's file, by name when
    the names match and by position when the auto-numbered names
    differ; a file of another graph is refused before anything loads."""
    x, _ = _learnable_data(n=32)
    jm, pm, names = _pair(_mlp, lambda K: K.SGD(learning_rate=0.2))
    src, dst = (jm, pm) if direction == "jax_to_port" else (pm, jm)
    fresh = _compile(_mlp(pk if dst is pm else jk), ft if dst is pm else ff,
                     (pk if dst is pm else jk).SGD(), SCCE, ["accuracy"], 32)
    rng = np.random.default_rng(7)
    for p in src.ffmodel.parameters:   # weights no init would draw
        src.ffmodel.set_weights(p.name, rng.standard_normal(
            p.shape).astype(np.float32))
    path = str(tmp_path / "w")
    src.save_weights(path)
    with np.load(path + ".npz") as f:
        assert sorted(f.files, key=lambda k: int(k.split(":")[0])) == [
            f"{i}:{p.name}" for i, p in enumerate(src.ffmodel.parameters)]
    fresh.load_weights(path)
    _close(fresh.predict(x), src.predict(x), "predict after load")
    other = _compile(_dense_softmax(pk if dst is pm else jk),
                     ft if dst is pm else ff,
                     (pk if dst is pm else jk).SGD(), SCCE, ["accuracy"], 32)
    with pytest.raises(ValueError, match="weights file has"):
        other.load_weights(path)


def test_preprocessing_equals_the_jax_package():
    """pad_sequences, Tokenizer and the image helpers give the JAX
    package's arrays."""
    seqs = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10]]
    for kw in ({}, dict(maxlen=4), dict(maxlen=4, padding="post",
                                        truncating="post")):
        np.testing.assert_array_equal(
            pk.preprocessing.pad_sequences(seqs, **kw),
            jk.preprocessing.pad_sequences(seqs, **kw))
    texts = ["the cat sat", "the dog sat down", "a cat"]
    tp, tj = (pk.preprocessing.Tokenizer(num_words=6),
              jk.preprocessing.Tokenizer(num_words=6))
    tp.fit_on_texts(texts)
    tj.fit_on_texts(texts)
    assert tp.texts_to_sequences(texts) == tj.texts_to_sequences(texts)
    np.testing.assert_array_equal(
        tp.sequences_to_matrix(tp.texts_to_sequences(texts)),
        tj.sequences_to_matrix(tj.texts_to_sequences(texts)))
    img = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    np.testing.assert_array_equal(
        pk.preprocessing.image.img_to_array(img),
        jk.preprocessing.image.img_to_array(img))
