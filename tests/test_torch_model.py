"""AlexNet end to end: the port's FFModel against the JAX package's.

Both packages build ``build_alexnet(num_classes=10, image_size=64)`` at
batch 4 in float32; the JAX side runs channels-last with its Pallas
max-pool kernel (interpret mode on the CPU).  The JAX model's weights
are carried into the port with ``interop.params_from_jax_numpy`` and the
two ``predict`` outputs must agree within 1e-5 on probabilities (the
convolutions sum in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu.ops.pallas_pool as pallas_pool
import flexflow_tpu_torch as ft
from flexflow_tpu.models.alexnet import build_alexnet as jax_alexnet
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu_torch import interop, model as tmodel
from flexflow_tpu_torch.models import build_alexnet

BS = 4
IMAGE = 64


@pytest.fixture(scope="module")
def jax_model():
    mp = pytest.MonkeyPatch()
    mp.setenv("FF_PALLAS_POOL", "1")
    calls = []
    real = pallas_pool.pallas_max_pool_nhwc

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    mp.setattr(pallas_pool, "pallas_max_pool_nhwc", spy)
    cfg = ff.FFConfig(batch_size=BS, compute_dtype="float32",
                      conv_layout="nhwc")
    m, _, _ = jax_alexnet(cfg, num_classes=10, image_size=IMAGE)
    m.compile(ff.SGDOptimizer(lr=0.01), mesh=MachineMesh({"n": 1}))
    m.init_layers(seed=0)
    x = np.random.default_rng(0).standard_normal(
        (6, 3, IMAGE, IMAGE)).astype(np.float32)
    y = m.predict(x, batch_size=BS)
    mp.undo()
    assert len(calls) == 3, "the JAX forward must run the Pallas pools"
    weights = {p.name: m.get_weights(p.name) for p in m.parameters}
    return weights, x, np.asarray(y, np.float32)


def _port_model(layout="auto"):
    cfg = ft.FFConfig(batch_size=BS, compute_dtype="float32",
                      conv_layout=layout)
    m, _, _ = build_alexnet(cfg, num_classes=10, image_size=IMAGE,
                            device="cpu")
    m.compile()
    m.init_layers(seed=0)
    return m


@pytest.mark.parametrize("layout", ["auto", "nhwc"])
def test_alexnet_predict_matches_jax(jax_model, layout):
    weights, x, want = jax_model
    m = _port_model(layout)
    assert {p.name for p in m.parameters} == set(weights)
    interop.params_from_jax_numpy(m, weights)
    got = m.predict(x, batch_size=BS)
    assert got.shape == want.shape == (6, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_interop_refuses_mismatched_names(jax_model):
    weights, _, _ = jax_model
    m = _port_model()
    extra = dict(weights, **{"dense_9/kernel": np.zeros((1, 1))})
    with pytest.raises(ValueError, match="only in the JAX model"):
        interop.params_from_jax_numpy(m, extra)
    short = dict(weights)
    short.pop("conv2d/bias")
    with pytest.raises(ValueError, match="only in the port"):
        interop.params_from_jax_numpy(m, short)


def test_weights_round_trip_and_seeded_init():
    a, b = _port_model(), _port_model()
    for p in a.parameters:
        np.testing.assert_array_equal(a.get_weights(p.name),
                                      b.get_weights(p.name))
    w = np.full(a.get_weights("dense_2/bias").shape, 0.25, np.float32)
    a.set_weights("dense_2/bias", w)
    np.testing.assert_array_equal(a.get_weights("dense_2/bias"), w)
    assert a.num_parameters == sum(
        a.get_weights(p.name).size for p in a.parameters)


def test_model_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.FFModel(ft.FFConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_alexnet(ft.FFConfig(batch_size=2))
    assert tmodel.FFModel(ft.FFConfig(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw,exc,match", [
    ({"strategies": {"conv2d": ft.ParallelConfig(dims=(2, 1, 1, 1),
                                                  device_ids=(0, 1))}},
     ValueError, "strategy needs 2 devices, have 1"),
    ({"calibration_file": "table.json"}, ValueError,
     "cannot load calibration table 'table.json'"),
    ({"workers_per_node": 2}, NotImplementedError, "one device"),
    ({"mesh_shape": {"n": 2}}, NotImplementedError, "one device"),
    ({"gradient_accumulation_steps": 0}, ValueError,
     "gradient_accumulation_steps must be >= 1"),
    ({"steps_per_dispatch": 0}, ValueError, "steps_per_dispatch must be >= 1"),
    ({"cost_estimator": "ridge"}, ValueError,
     "estimator 'ridge' needs a calibration table"),
    ({"trace_dir": "traces"}, NotImplementedError, "trace_dir"),
])
def test_compile_refuses_what_it_cannot_run(kw, exc, match):
    """What the port cannot run yet raises NotImplementedError; a
    strategy that needs more devices than the one the port runs on, and
    a training-loop knob below 1, raise ValueError, as in the JAX
    package; so does a calibration setting that does not resolve (the
    JAX package's ``estimator_from_config`` errors, raised at compile)."""
    cfg = ft.FFConfig(batch_size=BS, compute_dtype="float32", **kw)
    m, _, _ = build_alexnet(cfg, num_classes=10, image_size=IMAGE,
                            device="cpu")
    with pytest.raises(exc, match=match):
        m.compile()


def test_compile_keeps_the_label_and_loss_rules():
    m = _port_model()
    assert m.loss_type == "sparse_categorical_crossentropy"
    # graph ends in softmax: the logit loss reads the softmax input
    assert m._loss_tensor is m.layers[-1].inputs[0]
    assert m.label_tensor.shape == (BS, 1)
    assert m.label_tensor.dtype == "int32"
    assert m.resolved_conv_layout == "nchw"


def test_config_has_the_jax_fields_defaults_and_validation():
    def defaults(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else f.default_factory())
                for f in dataclasses.fields(cls)}

    assert defaults(ft.FFConfig) == defaults(ff.FFConfig)
    for bad in ({"compute_dtype": "fp8"}, {"param_dtype": "int8"},
                {"serve_quantize": "int4"}, {"serve_prefix_cache": "maybe"},
                {"serve_kv_page": 0}, {"serve_kv_pages": -1},
                {"serve_spec_gamma": 1}, {"serve_spec_gamma_max": 1},
                {"serve_spec_policy": "greedy"}):
        with pytest.raises(ValueError):
            ff.FFConfig(**bad)
        with pytest.raises(ValueError):
            ft.FFConfig(**bad)
    with pytest.raises(ValueError, match="precision"):
        ft.ParallelConfig(precision="f16")
