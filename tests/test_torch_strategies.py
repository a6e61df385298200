"""Strategies that change a one-device run, in the port against the JAX
package, on the CPU in float32.

* DLRM under the reference's hetero strategy (its tables host-placed,
  ``generate_dlrm_hetero_strategy``) from the JAX model's weights: the
  forward, three ``train_batch`` steps' losses and every parameter, the
  tables included, within 1e-5 (float32 sums of one row's duplicate-id
  gradients, and the JAX run's sum over its two devices, may run in
  another order), under plain SGD (the port's row update on the host),
  SGD with momentum and SGD with weight decay (its dense update on the
  host, every row moved), and under gradient accumulation.  The JAX
  package trains a host-placed table on a two-device data-parallel mesh,
  as its own test does (``tests/test_dlrm.py``): on a one-device mesh
  its step fails in this jaxlib (a pinned-host buffer where the step
  wants a device one), while its forward runs on one device.
* A small Transformer whose attention ops a strategy pins to bf16 in a
  float32 session: forward and loss against the JAX package within
  1e-5 (both cast the same operands to bf16 and accumulate in float32),
  the parameters after one SGD step (lr 0.05) within 1e-4: a gradient
  element that rounds to the neighbouring bf16 value moves its
  parameter by lr times one bf16 ulp (2^-8 of values up to about 0.5);
  the unpinned run is the control at 1e-5.  Against the port's own
  unpinned run the bf16 attention is a different result, within 2e-2 on
  logits up to about 4 (2^-8 relative, four of them); a pin that equals
  the session dtype, or a strategy with no pins, changes nothing:
  bit-equal.
* ``export_strategy_file`` writes the JAX package's bytes; a checkpoint
  written under a strategy by either package loads in the other with
  the same ``strategy_digest`` (the JAX loader sees no change of plan);
  a strategy that needs 8 devices is refused with the JAX message; the
  refusals that remain name the roadmap item that lifts them.
"""

import os

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as ft
from flexflow_tpu.models.dlrm import build_dlrm as jax_dlrm
from flexflow_tpu.models.transformer import build_transformer as jax_tf
from flexflow_tpu.parallel.mesh import MachineMesh
from flexflow_tpu.strategy import dlrm_gen as jax_gen
from flexflow_tpu.strategy import proto as jax_proto
from flexflow_tpu_torch import interop, resilience
from flexflow_tpu_torch.strategy import dlrm_gen as port_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
BF16_TOL = 2e-2
BF16_STEP_TOL = 1e-4
BS = 8
DLRM = dict(embedding_size=(50, 80), sparse_feature_size=8,
            mlp_bot=(4, 16, 8), mlp_top=(24, 16, 1))
TF = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, seq_len=8,
          vocab_size=64, num_classes=3)
OPTIMIZERS = {"sgd": dict(lr=0.1), "momentum": dict(lr=0.1, momentum=0.9),
              "decay": dict(lr=0.1, weight_decay=1e-2)}


def _weights(m):
    return {p.name: np.asarray(m.get_weights(p.name), np.float32)
            for p in m.parameters}


def _dlrm(pkg, strategies=None, opt="sgd", jax_devices=1, **cfg_kw):
    cfg = pkg.FFConfig(batch_size=BS, compute_dtype="float32", **cfg_kw)
    if strategies is not None:
        cfg.strategies = strategies
    if pkg is ff:
        m, _, preds = jax_dlrm(cfg, **DLRM)
        m.compile(ff.SGDOptimizer(**OPTIMIZERS[opt]), metrics=[],
                  final_tensor=preds,
                  mesh=MachineMesh({"n": jax_devices}))
    else:
        m, _, preds = ft.build_dlrm(cfg, **DLRM, device="cpu")
        m.compile(ft.SGDOptimizer(**OPTIMIZERS[opt]), metrics=[],
                  final_tensor=preds)
    m.init_layers(seed=0)
    return m


def _dlrm_batches(n_steps=3, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        xs = [rng.integers(0, v, (BS, 1)).astype(np.int32)
              for v in DLRM["embedding_size"]]
        # a repeated id: its row gradient sums over two samples
        xs[0][1] = xs[0][0]
        xs.append(rng.standard_normal((BS, 4)).astype(np.float32))
        out.append((xs, rng.random((BS, 1)).astype(np.float32)))
    return out


def _hetero(gen):
    return gen.generate_dlrm_hetero_strategy(1, 1, num_embeddings=2)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_hetero_dlrm_trains_equal_to_jax(opt):
    ref = _dlrm(ff, _hetero(jax_gen), opt, jax_devices=2)
    port = _dlrm(ft, _hetero(port_gen), opt)
    assert sorted(port._host_params) == ["embedding0/table",
                                         "embedding1/table"]
    # the JAX package keeps host tables off its sparse path; so does the
    # port, and plain SGD takes the row update on the host instead
    assert not ref._sparse_embedding_specs() and not port._sparse_specs
    assert bool(port._host_rows) == (opt == "sgd")
    w_start = _weights(ref)
    interop.params_from_jax_numpy(port, w_start)
    batches = _dlrm_batches()
    xs0 = batches[0][0]
    np.testing.assert_allclose(port.predict(xs0), np.asarray(
        ref.predict(xs0), np.float32), rtol=TOL, atol=TOL)
    tables = {n: port._params[n] for n in port._host_params}
    for xs, y in batches:
        lj = float(ref.train_batch(*xs, y))
        lp = float(port.train_batch(*xs, y))
        np.testing.assert_allclose(lp, lj, rtol=TOL, atol=TOL)
    # the tables never left their host buffers
    for n, t in tables.items():
        assert port._params[n] is t and t.device.type == "cpu"
    wj, wp = _weights(ref), _weights(port)
    for name in wj:
        np.testing.assert_allclose(wp[name], wj[name], rtol=TOL, atol=TOL,
                                   err_msg=name)
    # a row no batch looked up keeps its bits under plain SGD (the row
    # update) and momentum (its velocity stays 0); weight decay moves
    # every row
    touched = {int(i) for xs, _ in batches for i in xs[0].ravel()}
    untouched = [r for r in range(DLRM["embedding_size"][0])
                 if r not in touched]
    before = w_start["embedding0/table"][untouched]
    after = wp["embedding0/table"][untouched]
    if opt == "decay":
        assert np.all(np.any(after != before, axis=1))
    else:
        np.testing.assert_array_equal(after, before)


def test_hetero_dlrm_accumulation_and_imperative_loop():
    """Gradient accumulation and the set_batch/backward/update loop run a
    host table on the dense path.  The JAX package's accumulated step and
    its imperative update fail on a host table in this jaxlib (host and
    device operands in one update), so both are held against the JAX
    package's ``train_batch`` on the same batch, which they equal up to
    float32 rounding (2 microbatches of a mean-reduced loss are the full
    batch's mean)."""
    for kw in ({"gradient_accumulation_steps": 2}, {}):
        ref = _dlrm(ff, _hetero(jax_gen), "sgd", jax_devices=2)
        port = _dlrm(ft, _hetero(port_gen), "sgd", **kw)
        interop.params_from_jax_numpy(port, _weights(ref))
        xs, y = _dlrm_batches(1)[0]
        losses = [float(ref.train_batch(*xs, y))]
        if kw:
            assert not port._host_rows
            losses.append(float(port.train_batch(*xs, y)))
        else:
            port.set_batch(*xs, y)
            port.zero_gradients()
            losses.append(float(port.backward()))
            port.update()
        np.testing.assert_allclose(losses[1], losses[0], rtol=TOL,
                                   atol=TOL)
        wj, wp = _weights(ref), _weights(port)
        for name in wj:
            np.testing.assert_allclose(wp[name], wj[name], rtol=TOL,
                                       atol=TOL, err_msg=name)


def test_host_table_serves_and_evaluates_like_jax():
    ref = _dlrm(ff, _hetero(jax_gen))
    port = _dlrm(ft, _hetero(port_gen))
    interop.params_from_jax_numpy(port, _weights(ref))
    xs, y = _dlrm_batches(1, seed=9)[0]
    lj, _ = ref.evaluate(xs, y, batch_size=BS)
    lp, _ = port.evaluate(xs, y, batch_size=BS)
    np.testing.assert_allclose(lp, lj, rtol=TOL, atol=TOL)
    with ft.ServingEngine(port) as eng:
        out = eng.submit(*xs).result(timeout=60)
    np.testing.assert_allclose(out, np.asarray(ref.predict(xs), np.float32),
                               rtol=TOL, atol=TOL)


def test_host_placed_linear_serves_like_device_placed():
    """A host-placed Linear keeps its parameters in host memory, streams
    them to the device for its forward, and serves the same values as
    the device-placed model from the same weights."""
    s = {"bot_dense_0": ft.ParallelConfig(
        device_type=ft.DeviceType.HOST, dims=(1, 1),
        memory_types=(ft.MemoryType.ZCM,))}
    host, dev = _dlrm(ft, s), _dlrm(ft)
    assert host._host_stream == ["bot_dense_0/kernel", "bot_dense_0/bias"]
    interop.params_from_jax_numpy(host, _weights(dev))
    xs, _ = _dlrm_batches(1, seed=9)[0]
    np.testing.assert_array_equal(host.predict(xs, batch_size=BS),
                                  dev.predict(xs, batch_size=BS))


def _tf(pkg, pin="", **cfg_kw):
    cfg = pkg.FFConfig(batch_size=4, compute_dtype="float32", **cfg_kw)
    if pin:
        cfg.strategies = {f"attention_{i}": pkg.ParallelConfig(
            dims=(1, 1, 1), device_ids=(0,), precision=pin)
            for i in range(TF["num_layers"])}
    if pkg is ff:
        m, _, logits = jax_tf(cfg, **TF)
        extra = {"mesh": MachineMesh({"n": 1})}
    else:
        m, _, logits = ft.build_transformer(cfg, **TF, device="cpu")
        extra = {}
    m.compile(pkg.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
              ["accuracy"], final_tensor=logits, **extra)
    m.init_layers(seed=0)
    return m


def _tf_batch(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, TF["vocab_size"], (4, TF["seq_len"])).astype(
        np.int32)
    return x, rng.integers(0, TF["num_classes"], (4, 1)).astype(np.int32)


@pytest.mark.parametrize("pin,tol", [("bf16", BF16_STEP_TOL), ("", TOL)])
def test_pinned_attention_matches_jax(pin, tol):
    """Forward, loss and one SGD step of the Transformer with its
    attention ops pinned to bf16 in a float32 session; the verifier's
    FF141 row counts the pins.  The unpinned run is the control."""
    ref = _tf(ff, pin)
    port = _tf(ft, pin)
    interop.params_from_jax_numpy(port, _weights(ref))
    x, y = _tf_batch()
    np.testing.assert_allclose(port.predict(x), np.asarray(
        ref.predict(x), np.float32), rtol=TOL, atol=TOL)
    lj = float(ref.train_batch(x, y))
    lp = float(port.train_batch(x, y))
    np.testing.assert_allclose(lp, lj, rtol=TOL, atol=TOL)
    wj, wp = _weights(ref), _weights(port)
    for name in wj:
        np.testing.assert_allclose(wp[name], wj[name], rtol=tol, atol=tol,
                                   err_msg=name)
    summary = [d for d in port.verify_report if d.code == "FF141"]
    assert len(summary) == (1 if pin else 0)
    assert not port.verify_report.errors


def test_pinned_attention_differs_from_unpinned_and_only_there():
    """A bf16 pin changes the run (the attention rounds to bf16); a pin
    to the session dtype, and a strategy of unpinned one-device configs
    for every op, are bit-equal to no strategy."""
    x, _ = _tf_batch()
    base = _tf(ft)
    w0 = _weights(base)
    out = {}
    for label, model in (("bf16", _tf(ft, "bf16")), ("f32", _tf(ft, "f32"))):
        interop.params_from_jax_numpy(model, w0)
        out[label] = model.predict(x)
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32")
    m, _, logits = ft.build_transformer(cfg, **TF, device="cpu")
    cfg.strategies = {op.name: ft.ParallelConfig(
        dims=(1,) * op.outputs[0].num_dims, device_ids=(0,))
        for op in m.layers}
    m.compile(ft.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
              [], final_tensor=logits)
    m.init_layers(seed=0)
    interop.params_from_jax_numpy(m, w0)
    ref = base.predict(x)
    np.testing.assert_array_equal(out["f32"], ref)
    np.testing.assert_array_equal(m.predict(x), ref)
    assert not np.array_equal(out["bf16"], ref)
    np.testing.assert_allclose(out["bf16"], ref, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_export_strategy_file_same_bytes(tmp_path):
    paths = {}
    for pkg, gen in ((ff, jax_gen), (ft, port_gen)):
        path = str(tmp_path / f"{pkg.__name__}.pb")
        _dlrm(pkg, _hetero(gen), export_strategy_file=path)
        paths[pkg] = path
    with open(paths[ff], "rb") as f:
        want = f.read()
    with open(paths[ft], "rb") as f:
        assert f.read() == want
    # only the entries that name an op are written
    assert sorted(jax_proto.loads(want)) == [
        "bot_dense_0", "bot_dense_1", "embedding0", "embedding1",
        "interact", "mse_loss", "top_dense_0", "top_dense_1"]


def test_import_strategy_file(tmp_path):
    path = str(tmp_path / "hetero.pb")
    jax_proto.save_strategy_file(path, _hetero(jax_gen))
    port = _dlrm(ft, import_strategy_file=path)
    assert sorted(port._host_params) == ["embedding0/table",
                                         "embedding1/table"]
    emb = next(op for op in port.layers if op.name == "embedding0")
    assert emb.parallel_config.memory_types == (ft.MemoryType.ZCM,) * 3
    assert {d.code for d in port.verify_report} == {"FF110"}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_under_strategy_loads_across(tmp_path, writer):
    """A checkpoint saved under a strategy (the homogeneous DLRM
    generator's on one device, with a bf16 pin) by one package loads in
    the other; both record the same strategy_digest, so the JAX loader
    sees no change of plan (no reshard on resume)."""
    def strategy(pkg, gen):
        s = gen.generate_dlrm_strategy(1, 1, num_embeddings=2)
        s["bot_dense_1"] = pkg.ParallelConfig(dims=(1, 1), device_ids=(0,),
                                              precision="bf16")
        return s

    ref = _dlrm(ff, strategy(ff, jax_gen))
    port = _dlrm(ft, strategy(ft, port_gen))
    interop.params_from_jax_numpy(port, _weights(ref))
    xs, y = _dlrm_batches(1)[0]
    path = str(tmp_path / "ckpt")
    src, dst = (port, ref) if writer == "port" else (ref, port)
    src.train_batch(*xs, y)
    src.save_checkpoint(path)
    data = resilience.read_npz_verified(path + ".npz")
    meta = resilience.manifest_meta(data)
    assert meta["strategy_digest"] == port._strategy_digest() == \
        ref._strategy_digest()
    if dst is ref:
        resharded = []
        real = ref._reshard_if_mesh_changed

        def spy(arrays, p="<checkpoint>"):
            resharded.append(real(arrays, p))
            return resharded[-1]

        ref._reshard_if_mesh_changed = spy
        ref.load_checkpoint(path)
        assert resharded == [False]
    else:
        port.load_checkpoint(path)
    for name, w in _weights(src).items():
        np.testing.assert_array_equal(_weights(dst)[name], w, err_msg=name)


def test_strategy_digest_follows_the_plan():
    plain = _dlrm(ft)
    hetero = _dlrm(ft, _hetero(port_gen))
    assert plain._strategy_digest() == _dlrm(ff)._strategy_digest()
    assert hetero._strategy_digest() != plain._strategy_digest()


def test_eight_device_strategy_refused_with_the_jax_message():
    path = os.path.join(REPO, "artifacts", "searched_transformer_b8_8dev.pb")
    for pkg in (ff, ft):
        cfg = pkg.FFConfig(batch_size=8, import_strategy_file=path,
                           workers_per_node=1)
        build = jax_tf if pkg is ff else ft.build_transformer
        kw = {} if pkg is ff else {"device": "cpu"}
        m, _, logits = build(cfg, num_layers=12, d_model=64, num_heads=4,
                             d_ff=128, seq_len=16, vocab_size=100,
                             num_classes=2, **kw)
        with pytest.raises(ValueError,
                           match="strategy needs 8 devices, have 1"):
            m.compile(pkg.SGDOptimizer(lr=0.1),
                      "sparse_categorical_crossentropy", [],
                      final_tensor=logits)


@pytest.mark.parametrize("field,value,exc,item", [
    ("calibration_file", "table.json", ValueError,
     "cannot load calibration table"),
    ("cost_estimator", "table", ValueError, "needs a calibration table"),
    ("trace_dir", "traces", NotImplementedError, "A.11"),
    ("mesh_shape", {"n": 2}, NotImplementedError, "A.8"),
    ("workers_per_node", 2, NotImplementedError, "A.8")])
def test_remaining_refusals_name_their_roadmap_item(field, value, exc, item):
    """What the port still refuses names its roadmap item; a calibration
    setting that does not resolve raises the JAX package's ValueError."""
    with pytest.raises(exc, match=item.replace(".", r"\.")):
        _dlrm(ft, **{field: value})
