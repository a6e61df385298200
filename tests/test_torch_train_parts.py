"""The port's losses, metrics and optimizers against the JAX package's.

Same seeded numpy inputs through both; every result must agree within
1e-6 (float32 arithmetic in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.losses as jlosses
import flexflow_tpu.metrics as jmetrics
import flexflow_tpu.optimizers as jopt
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import losses, metrics, optimizers
from flexflow_tpu_torch.data import PrefetchLoader

TOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL)


def _loss_inputs(loss_type, rank3=False):
    rng = np.random.default_rng(3)
    if loss_type in (losses.SPARSE_CATEGORICAL_CROSSENTROPY, "scce"):
        if rank3:
            return (rng.standard_normal((4, 5, 7)).astype(np.float32),
                    rng.integers(0, 7, (4, 5)).astype(np.int32))
        return (rng.standard_normal((6, 7)).astype(np.float32),
                rng.integers(0, 7, (6, 1)).astype(np.int32))
    preds = rng.random((6, 7)).astype(np.float32)
    labels = rng.random((6, 7)).astype(np.float32)
    return preds, labels


@pytest.mark.parametrize("loss_type,rank3", [
    ("sparse_categorical_crossentropy", False),
    ("sparse_categorical_crossentropy", True),
    ("scce", False),
    ("categorical_crossentropy", False),
    ("mean_squared_error", False),
    ("mean_squared_error_avg_reduce", False),
    ("mean_squared_error_sum_reduce", False),
    ("mse", False)])
def test_losses_match_jax(loss_type, rank3):
    preds, labels = _loss_inputs(loss_type, rank3)
    want = jlosses.get_loss_fn(loss_type)(jnp.asarray(preds),
                                          jnp.asarray(labels))
    got = losses.get_loss_fn(loss_type)(torch.from_numpy(preds),
                                        torch.from_numpy(labels))
    _close(got, want)
    jfn, jred = jlosses.get_per_example_loss_fn(loss_type)
    fn, red = losses.get_per_example_loss_fn(loss_type)
    assert red == jred
    _close(fn(torch.from_numpy(preds), torch.from_numpy(labels)),
           jfn(jnp.asarray(preds), jnp.asarray(labels)))


def test_scce_takes_flat_labels_and_unknown_loss_raises():
    logits, labels = _loss_inputs("scce")
    fn = losses.get_loss_fn("sparse_crossentropy")
    _close(fn(torch.from_numpy(logits), torch.from_numpy(labels[:, 0])),
           jlosses.get_loss_fn("scce")(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get_loss_fn("hinge")


def _metric_cases():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    probs = rng.random((6, 5)).astype(np.float32)
    seq = rng.standard_normal((3, 4, 5)).astype(np.float32)
    return [
        ("int labels", logits, rng.integers(0, 5, (6, 1)).astype(np.int32),
         ["accuracy", "sparse_categorical_crossentropy"]),
        ("dense labels", probs, rng.random((6, 5)).astype(np.float32),
         ["accuracy", "categorical_crossentropy", "mean_squared_error",
          "root_mean_squared_error", "mean_absolute_error"]),
        ("tokens", seq, rng.integers(0, 5, (3, 4)).astype(np.int32),
         ["accuracy", "sparse_categorical_crossentropy"]),
    ]


@pytest.mark.parametrize("nvalid", [None, 2])
@pytest.mark.parametrize("case", range(3))
def test_batch_metrics_match_jax(case, nvalid):
    _, preds, labels, names = _metric_cases()[case]
    want = jmetrics.compute_batch_metrics(
        jnp.asarray(preds), jnp.asarray(labels), names,
        "sparse_categorical_crossentropy", nvalid=nvalid)
    got = metrics.compute_batch_metrics(
        torch.from_numpy(preds), torch.from_numpy(labels), names,
        "sparse_categorical_crossentropy", nvalid=nvalid)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    jpm, pm = jmetrics.PerfMetrics(), metrics.PerfMetrics()
    jpm.update(want)
    pm.update(got)
    assert pm.report(names) == jpm.report(names)
    assert pm.scalars().keys() == jpm.scalars().keys()
    for k, v in jpm.scalars().items():
        _close(pm.scalars()[k], v)


def test_canonicalize_metrics_matches_jax():
    names = ["acc", "scce", "mse", "rmse", "mae", "cce",
             "sparse_categorical_accuracy"]
    assert (metrics.canonicalize_metrics(names)
            == jmetrics.canonicalize_metrics(names))
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.canonicalize_metrics(["accuracyy"])


@pytest.mark.parametrize("kind,kw", [
    ("sgd", {"lr": 0.1}),
    ("sgd", {"lr": 0.1, "weight_decay": 1e-2}),
    ("sgd", {"lr": 0.05, "momentum": 0.9}),
    ("sgd", {"lr": 0.05, "momentum": 0.9, "nesterov": True,
             "weight_decay": 1e-3}),
    ("adam", {}),
    ("adam", {"alpha": 0.01, "beta1": 0.8, "weight_decay": 1e-2,
              "epsilon": 1e-6})])
def test_optimizer_three_steps_match_jax(kind, kw):
    rng = np.random.default_rng(5)
    params = {"a/kernel": rng.standard_normal((4, 3)).astype(np.float32),
              "a/bias": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jo, to = jopt.get_optimizer(kind, **kw), optimizers.get_optimizer(kind,
                                                                      **kw)
    assert to.slot_bytes_per_param == jo.slot_bytes_per_param
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init_state(jp), to.init_state(tp)
    for g in grads:
        jp, js = jo.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                           js)
        tp, ts = to.update(tp, {k: torch.from_numpy(v) for k, v in
                                g.items()}, ts)
    for k in params:
        _close(tp[k], jp[k])
    for slot in ("v", "m"):
        for k in (js.get(slot) or {}):
            _close(ts[slot][k], js[slot][k])


def test_optimizer_update_is_functional_and_names_resolve():
    w = {"w": torch.ones(3)}
    opt = ft.SGDOptimizer(lr=0.5, momentum=0.9)
    state = opt.init_state(w)
    new, new_state = opt.update(w, {"w": torch.ones(3)}, state)
    assert torch.equal(w["w"], torch.ones(3))
    assert torch.equal(state["v"]["w"], torch.zeros(3))
    assert torch.equal(new["w"], torch.full((3,), 0.5))
    assert isinstance(optimizers.get_optimizer("AdamW"), ft.AdamOptimizer)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.get_optimizer("lamb")


def test_synthetic_dataset_matches_jax_and_loader_drops_the_tail(capsys):
    from flexflow_tpu.data.dataloader import \
        synthetic_dataset as jax_synthetic

    want = jax_synthetic(10, [(3, 4, 4), (5,)], (1,), num_classes=7,
                         seed=3, input_dtypes=["float32", "int32"])
    got = ft.synthetic_dataset(10, [(3, 4, 4), (5,)], (1,), num_classes=7,
                               seed=3, input_dtypes=["float32", "int32"])
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        np.testing.assert_array_equal(a, b)

    class Stub:
        device = torch.device("cpu")
        config = ft.FFConfig(batch_size=4)

    capsys.readouterr()
    loader = PrefetchLoader(Stub(), got[0], got[1])
    assert "[ff] info: dropping 2 tail samples" in capsys.readouterr().err
    assert loader.num_samples_used == 8
    batches = list(loader)
    assert len(batches) == 2 and all(len(b) == 3 for b in batches)
    np.testing.assert_array_equal(batches[1][0].numpy(), got[0][0][4:8])
    np.testing.assert_array_equal(batches[1][2].numpy(), got[1][4:8])
