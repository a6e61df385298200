"""Checkpoints of the port, case by case after ``tests/test_checkpoint.py``,
and across packages: a file written by the JAX package loads into the
port and the reverse, each followed by one more training step that
matches the other package's next step.

Both packages write the JAX package's ``.npz`` format: ``param:<name>``
(BatchNorm's running statistics included), ``opt:<i>`` (the optimizer
state's leaves in ``jax.tree_util`` flatten order), ``meta:step`` and
the CRC manifest under ``meta:manifest``.

Tolerances: within the port, a resumed run is bit-equal to the
uninterrupted one.  Across packages the restored state is bit-equal
(the arrays are float32 either way), and the next step's loss,
parameters, running statistics and optimizer slots agree within 1e-5
relative and 1e-6 absolute (float32 sums in another order; Adam at
alpha 1e-4, where an element within noise of 0 cannot stray).
"""

import json
import os

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu import faults
from flexflow_tpu import resilience as jax_resilience
from flexflow_tpu.parallel.mesh import MachineMesh
import flexflow_tpu_torch as ft
from flexflow_tpu_torch import interop
from flexflow_tpu_torch.resilience import (MANIFEST_KEY,
                                           CorruptCheckpointError,
                                           _atomic_savez,
                                           latest_valid_checkpoint,
                                           manifest_meta, read_npz_verified,
                                           verify_checkpoint)

RTOL = 1e-5
ATOL = 1e-6


def _mlp(width=32, optimizer=None, extra=False, pkg=ft):
    cfg = pkg.FFConfig(batch_size=16, compute_dtype="float32")
    m = (ft.FFModel(cfg, device="cpu") if pkg is ft
         else ff.FFModel(cfg, mesh=MachineMesh({"n": 1})))
    x = m.create_tensor((16, 8), name="x")
    t = m.dense(x, width, activation="relu")
    if extra:
        t = m.dense(t, 16, activation="relu")
    t = m.dense(t, 4)
    m.compile(optimizer or pkg.SGDOptimizer(lr=0.1, momentum=0.9),
              "sparse_categorical_crossentropy", [], final_tensor=t)
    m.init_layers(seed=0)
    return m


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((16, 8), dtype=np.float32),
            rng.integers(0, 4, (16, 1)).astype(np.int32))


def _host(m):
    return {k: m.get_weights(k) for k in m._params}


def test_checkpoint_resume_bitwise(tmp_path):
    """Training N+M steps == training N, checkpointing, restoring into a
    FRESH model and training M (momentum and the step included)."""
    x, y = _data()
    a = _mlp()
    for _ in range(3):
        a.train_batch(x, y)
    ckpt = os.path.join(tmp_path, "ckpt.npz")
    a.save_checkpoint(ckpt)
    ref = [float(a.train_batch(x, y)) for _ in range(3)]

    b = _mlp()
    b.set_weights("dense/kernel", np.zeros((32, 8), np.float32))
    b.load_checkpoint(ckpt)
    assert b._step == 3
    got = [float(b.train_batch(x, y)) for _ in range(3)]
    assert got == ref
    for k, v in _host(a).items():
        np.testing.assert_array_equal(_host(b)[k], v, err_msg=k)
    for k, v in a._opt_state["v"].items():
        assert torch.equal(b._opt_state["v"][k], v), k


def test_load_checkpoint_validates_before_mutating(tmp_path):
    """A graph or optimizer mismatch fails cleanly and leaves the
    model's state untouched."""
    x, y = _data()
    a = _mlp()
    a.train_batch(x, y)
    ckpt = os.path.join(tmp_path, "a.npz")
    a.save_checkpoint(ckpt)

    b = _mlp(extra=True, optimizer=ft.SGDOptimizer(lr=0.1))
    before = _host(b)
    with pytest.raises(ValueError, match="does not match"):
        b.load_checkpoint(ckpt)
    for k, v in before.items():
        np.testing.assert_array_equal(v, b.get_weights(k))

    c = _mlp(optimizer=ft.AdamOptimizer())  # Adam has more slots
    before = _host(c)
    with pytest.raises(ValueError, match="optimizer state mismatch"):
        c.load_checkpoint(ckpt)
    for k, v in before.items():
        np.testing.assert_array_equal(v, c.get_weights(k))
    assert c._step == 0 and c._opt_state["t"] == 0


def test_load_checkpoint_rejects_shape_mismatch(tmp_path):
    """Same names, other widths: a clear error at load."""
    a = _mlp()
    a.save_checkpoint(os.path.join(tmp_path, "a.npz"))
    b = _mlp(width=64)
    with pytest.raises(ValueError, match="shape"):
        b.load_checkpoint(os.path.join(tmp_path, "a.npz"))


def test_async_checkpoint_roundtrip(tmp_path):
    """async_write=True: the state is captured at save time, the write
    overlaps training, and the restore reproduces the step after the
    save; a load right after an async save joins the writer."""
    x, y = _data()
    m = _mlp()
    m.train_batch(x, y)
    ckpt = str(tmp_path / "async_ck")
    m.save_checkpoint(ckpt, async_write=True)
    assert m._ckpt_writer is None or not m._ckpt_writer.daemon
    loss_after_save = float(m.train_batch(x, y))
    for _ in range(2):
        m.train_batch(x, y)
    m.wait_for_checkpoint()
    m.load_checkpoint(ckpt)
    assert float(m.train_batch(x, y)) == loss_after_save
    m.save_checkpoint(ckpt, async_write=True)
    m.load_checkpoint(ckpt)
    assert m._step == 2


def test_async_write_failure_is_raised_at_the_next_wait(tmp_path,
                                                       monkeypatch):
    from flexflow_tpu_torch import model as model_mod

    def boom(final, arrays):
        raise OSError("disk full")

    m = _mlp()
    monkeypatch.setattr(model_mod, "_atomic_savez", boom)
    m.save_checkpoint(str(tmp_path / "x"), async_write=True)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        m.wait_for_checkpoint()
    m.wait_for_checkpoint()  # raised once, then clear


def test_checkpoint_embeds_verifying_manifest(tmp_path):
    """The manifest covers every array and records the one-device
    topology and the default plan's strategy digest, the JAX package's
    own digest for the same graph; both packages' verify_checkpoint
    accept the file."""
    a = _mlp()
    x, y = _data()
    a.train_batch(x, y)
    ckpt = os.path.join(tmp_path, "man.npz")
    a.save_checkpoint(ckpt)
    assert verify_checkpoint(ckpt)
    assert jax_resilience.verify_checkpoint(ckpt)
    with np.load(ckpt) as f:
        assert MANIFEST_KEY in f.files
        man = json.loads(str(np.asarray(f[MANIFEST_KEY])))
        assert man["format_version"] == 2
        assert man["step"] == 1
        assert set(man["arrays"]) == set(f.files) - {MANIFEST_KEY}
        assert man["mesh_shape"] == {}
        assert man["num_devices"] == 1
        assert man["process_count"] == 1
        assert man["strategy_digest"] == _mlp(pkg=ff)._strategy_digest()


def test_manifest_v1_and_manifestless_backcompat(tmp_path):
    """A v1 manifest (CRC table only) and a manifest-less archive both
    verify and load."""
    a = _mlp()
    x, y = _data()
    a.train_batch(x, y)
    v2 = os.path.join(tmp_path, "v2.npz")
    a.save_checkpoint(v2)

    data = read_npz_verified(v2)
    man = json.loads(str(np.asarray(data[MANIFEST_KEY])))
    man_v1 = {"format_version": 1, "step": man["step"],
              "arrays": man["arrays"]}
    data[MANIFEST_KEY] = np.asarray(json.dumps(man_v1, sort_keys=True))
    v1 = _atomic_savez(os.path.join(tmp_path, "v1.npz"), data)
    assert verify_checkpoint(v1)
    meta = manifest_meta(read_npz_verified(v1))
    assert meta["format_version"] == 1
    assert meta["mesh_shape"] is None and meta["num_devices"] is None
    assert meta["strategy_digest"] is None
    b = _mlp()
    b.load_checkpoint(v1)
    assert b._step == 1

    bare = {k: v for k, v in data.items() if k != MANIFEST_KEY}
    v0 = _atomic_savez(os.path.join(tmp_path, "v0.npz"), bare)
    assert verify_checkpoint(v0)
    assert manifest_meta(read_npz_verified(v0)) is None
    c = _mlp()
    c.load_checkpoint(v0)
    assert c._step == 1


def test_corrupt_newest_with_valid_older_under_retention(tmp_path):
    """After keep_last pruned the family to its newest two, a corrupt
    newest file still falls back to the valid older one, and the port
    resumes from it."""
    a = _mlp()
    x, y = _data()
    for _ in range(4):
        a.train_batch(x, y)
        a.save_checkpoint(
            os.path.join(tmp_path, f"elastic_step{a._step}"), keep_last=2)
    kept = sorted(n for n in os.listdir(tmp_path) if n.endswith(".npz"))
    assert kept == ["elastic_step3.npz", "elastic_step4.npz"]
    faults.corrupt_file(os.path.join(tmp_path, "elastic_step4.npz"))
    with pytest.warns(UserWarning, match="checkpoint_skipped"):
        path = latest_valid_checkpoint(str(tmp_path))
    assert path == os.path.join(tmp_path, "elastic_step3.npz")
    b = _mlp()
    b.load_checkpoint(path)
    assert b._step == 3


def test_corrupt_checkpoint_raises_clear_error(tmp_path):
    """A truncated checkpoint raises CorruptCheckpointError naming the
    path and the fallback, and the model's state is untouched; a flipped
    byte fails the CRC the same way."""
    x, y = _data()
    a = _mlp()
    a.train_batch(x, y)
    ckpt = os.path.join(tmp_path, "trunc.npz")
    a.save_checkpoint(ckpt)
    flipped = os.path.join(tmp_path, "flip.npz")
    a.save_checkpoint(flipped)
    faults.corrupt_file(ckpt)
    before = _host(a)
    with pytest.raises(CorruptCheckpointError) as ei:
        a.load_checkpoint(ckpt)
    assert "trunc.npz" in str(ei.value)
    assert "latest_valid_checkpoint" in str(ei.value)
    assert a._step == 1
    for k, v in before.items():
        np.testing.assert_array_equal(v, a.get_weights(k))

    raw = bytearray(open(flipped, "rb").read())
    data = read_npz_verified(flipped)
    needle = data["param:dense/kernel"].tobytes()[:16]
    at = bytes(raw).index(needle)
    raw[at] ^= 0x01
    with open(flipped, "wb") as f:
        f.write(raw)
    assert not verify_checkpoint(flipped)
    with pytest.raises(CorruptCheckpointError, match="flip.npz"):
        a.load_checkpoint(flipped)


def test_stale_tmp_cleanup_and_retention(tmp_path):
    """save_checkpoint sweeps orphaned *.tmp.npz files of its family
    (other families' stay) and keep_last prunes the family."""
    a = _mlp()
    x, y = _data()
    stale = tmp_path / "elastic_step1.tmp.npz"
    stale.write_bytes(b"partial write")
    alien = tmp_path / "other_family.tmp.npz"
    alien.write_bytes(b"not ours")
    for _ in range(4):
        a.train_batch(x, y)
        a.save_checkpoint(
            os.path.join(tmp_path, f"elastic_step{a._step}"), keep_last=2)
    names = sorted(os.listdir(tmp_path))
    assert not stale.exists(), names
    assert alien.exists(), names
    assert [n for n in names if n.endswith(".npz") and "elastic" in n] == \
        ["elastic_step3.npz", "elastic_step4.npz"]


# ----------------------------------------------------------------------
# across packages
# ----------------------------------------------------------------------
def _small_resnet(pkg, optimizer):
    """A residual CNN with BatchNorm: a stem conv, one basic block
    (conv-BN-ReLU, conv-BN, the shortcut add, ReLU), a max pool and the
    head; 6 running statistics."""
    cfg = pkg.FFConfig(batch_size=4, compute_dtype="float32")
    m = (ft.FFModel(cfg, device="cpu") if pkg is ft
         else ff.FFModel(cfg, mesh=MachineMesh({"n": 1})))
    x = m.create_tensor((4, 3, 16, 16), name="image")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, use_bias=False)
    t = m.batch_norm(t)
    r = m.conv2d(t, 8, 3, 3, 1, 1, 1, 1, use_bias=False)
    r = m.batch_norm(r)
    r = m.conv2d(r, 8, 3, 3, 1, 1, 1, 1, use_bias=False)
    r = m.batch_norm(r, relu=False)
    t = m.relu(m.add(t, r))
    t = m.pool2d(t, 3, 3, 2, 2, 1, 1)
    t = m.flat(t)
    t = m.dense(t, 10)
    m.compile(optimizer(pkg), "sparse_categorical_crossentropy", [],
              final_tensor=t)
    m.init_layers(seed=0)
    return m


OPTIMIZERS = {
    "sgd_momentum": lambda pkg: pkg.SGDOptimizer(lr=0.05, momentum=0.9),
    "adam": lambda pkg: pkg.AdamOptimizer(alpha=1e-4),
}


def _resnet_batches(n=4):
    rng = np.random.default_rng(7)
    return [(rng.standard_normal((4, 3, 16, 16), dtype=np.float32),
             rng.integers(0, 10, (4, 1)).astype(np.int32))
            for _ in range(n)]


def _opt_leaves(m):
    """Flattened optimizer leaves of either package as numpy."""
    if isinstance(m, ft.FFModel):
        from flexflow_tpu_torch.model import _flatten_state, _leaf_to_host
        return [_leaf_to_host(v) for v in _flatten_state(m._opt_state)]
    import jax
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(m._opt_state)]


def _held(port, ref, what):
    for name, v in _host(ref).items():
        np.testing.assert_allclose(port.get_weights(name), v, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {name}")
    for i, (a, b) in enumerate(zip(_opt_leaves(port), _opt_leaves(ref))):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} opt:{i}")
    assert port._step == ref._step


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_jax_checkpoint_loads_into_the_port(tmp_path, opt):
    """The JAX package trains 2 steps and saves; a fresh port model
    loads the file (params, running statistics, optimizer state, step:
    bit-equal) and its next step matches the JAX model's."""
    batches = _resnet_batches()
    ref = _small_resnet(ff, OPTIMIZERS[opt])
    for xb, yb in batches[:2]:
        ref.train_batch(xb, yb)
    ckpt = os.path.join(tmp_path, "jax.npz")
    ref.save_checkpoint(ckpt)
    assert verify_checkpoint(ckpt)

    port = _small_resnet(ft, OPTIMIZERS[opt])
    port.load_checkpoint(ckpt)
    assert port._step == 2
    for name, v in _host(ref).items():
        np.testing.assert_array_equal(port.get_weights(name), v,
                                      err_msg=name)
    for a, b in zip(_opt_leaves(port), _opt_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    if opt == "adam":
        assert port._opt_state["t"] == 2
    stats = [p.name for p in port.parameters if not p.trainable]
    assert len(stats) == 6 and all(
        np.abs(port.get_weights(s) - (0.0 if "mean" in s else 1.0)).max()
        > 0 for s in stats)
    xb, yb = batches[2]
    lj = float(ref.train_batch(xb, yb))
    lp = float(port.train_batch(xb, yb))
    np.testing.assert_allclose(lp, lj, rtol=RTOL, atol=ATOL)
    _held(port, ref, "next step")


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_port_checkpoint_loads_into_jax(tmp_path, opt):
    """The port trains 2 steps (from the JAX model's weights) and saves;
    the file passes the JAX verify_checkpoint, loads in the JAX
    package's load_checkpoint with no reshard-on-resume, and the JAX
    model's next step matches the port's."""
    batches = _resnet_batches()
    ref = _small_resnet(ff, OPTIMIZERS[opt])
    port = _small_resnet(ft, OPTIMIZERS[opt])
    interop.params_from_jax_numpy(port, {p.name: np.asarray(
        ref.get_weights(p.name), np.float32) for p in ref.parameters})
    for xb, yb in batches[:2]:
        port.train_batch(xb, yb)
    ckpt = os.path.join(tmp_path, "port_step2")
    port.save_checkpoint(ckpt)
    assert jax_resilience.verify_checkpoint(ckpt + ".npz")

    resharded = []
    real = ref._reshard_if_mesh_changed

    def spy(data, path="<checkpoint>"):
        resharded.append(real(data, path))
        return resharded[-1]

    ref._reshard_if_mesh_changed = spy
    ref.load_checkpoint(ckpt)
    assert resharded == [False]
    assert ref._step == 2
    for name in port._params:
        np.testing.assert_array_equal(np.asarray(ref._params[name]),
                                      port.get_weights(name), err_msg=name)
    for a, b in zip(_opt_leaves(ref), _opt_leaves(port)):
        np.testing.assert_array_equal(a, b)
    xb, yb = batches[2]
    lj = float(ref.train_batch(xb, yb))
    lp = float(port.train_batch(xb, yb))
    np.testing.assert_allclose(lp, lj, rtol=RTOL, atol=ATOL)
    _held(port, ref, "next step")
