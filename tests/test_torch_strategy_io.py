"""Strategy files in the port (``flexflow_tpu_torch.strategy``) against
the JAX package's ``flexflow_tpu.strategy``, on the CPU.

The same bytes and the same strategies go through both packages, and
every comparison is exact: ``loads``/``dumps`` byte for byte on the five
committed ``artifacts/searched_*.pb`` and on 200 seeded random
strategies (with and without the precision field, packed and unpacked
repeated fields), ``strategy_digest`` character for character, the
``StrategyParseError`` text of every truncation of a file and of
hundreds of corrupted files, and the bytes both DLRM generators and
their command-line entry write.
"""

import glob
import io
import os
import random

import pytest

import flexflow_tpu.strategy.dlrm_gen as jax_gen
import flexflow_tpu.strategy.proto as jax_proto
import flexflow_tpu_torch.strategy.dlrm_gen as port_gen
import flexflow_tpu_torch.strategy.proto as port_proto
from flexflow_tpu import config as jax_config
from flexflow_tpu_torch import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = sorted(glob.glob(os.path.join(REPO, "artifacts",
                                          "searched_*.pb")))


def to_port(s):
    """A JAX-package strategy dict as the port's ParallelConfigs."""
    return {n: port_config.ParallelConfig(
        device_type=port_config.DeviceType(int(pc.device_type)),
        dims=tuple(pc.dims), device_ids=tuple(pc.device_ids),
        memory_types=tuple(port_config.MemoryType(int(m))
                           for m in pc.memory_types),
        precision=pc.precision) for n, pc in s.items()}


def same_config(a, b) -> bool:
    return (int(a.device_type) == int(b.device_type)
            and tuple(a.dims) == tuple(b.dims)
            and tuple(a.device_ids) == tuple(b.device_ids)
            and tuple(int(m) for m in a.memory_types)
            == tuple(int(m) for m in b.memory_types)
            and a.precision == b.precision)


def same_strategy(a, b) -> bool:
    return list(a) == list(b) and all(same_config(a[n], b[n]) for n in a)


def _rand_pc(rng: random.Random):
    c = jax_config
    ndims = rng.randint(1, 4)
    dims = tuple(rng.choice((1, 2, 3, 4, 6, 8, 16)) for _ in range(ndims))
    nparts = 1
    for d in dims:
        nparts *= d
    if rng.random() < 0.5:
        ids = tuple(range(nparts))
    else:
        ids = tuple(rng.randrange(0, 64) for _ in range(nparts))
    mts = tuple(rng.choice((c.MemoryType.FBM, c.MemoryType.ZCM))
                for _ in range(rng.randint(0, 3)))
    return c.ParallelConfig(
        device_type=rng.choice((c.DeviceType.DEVICE, c.DeviceType.HOST)),
        dims=dims, device_ids=ids, memory_types=mts,
        precision=rng.choice(("", "", "", "bf16", "f32")))


def _rand_strategy(rng: random.Random) -> dict:
    names = set()
    while len(names) < rng.randint(1, 8):
        names.add(rng.choice(
            ["conv", "dense", "embedding", "attn", "ln", "moe"])
            + f"_{rng.randrange(100)}")
    return {n: _rand_pc(rng) for n in sorted(names)}


def _parse_error(proto, data):
    try:
        return "ok", proto.loads(data)
    except proto.StrategyParseError as e:
        return "error", str(e)


def _same_outcome(data) -> None:
    kind_j, got_j = _parse_error(jax_proto, data)
    kind_p, got_p = _parse_error(port_proto, data)
    assert kind_j == kind_p, (data, got_j, got_p)
    if kind_j == "error":
        assert got_j == got_p
    else:
        assert same_strategy(got_j, got_p)


def test_committed_files_are_the_five():
    names = sorted(os.path.basename(p) for p in COMMITTED)
    assert names == [
        "searched_inception_v3_b128_32dev.pb",
        "searched_inception_v3_b128_8dev.pb",
        "searched_nmt_b256_8dev.pb",
        "searched_transformer_b32_8dev.pb",
        "searched_transformer_b8_8dev.pb"]


@pytest.mark.parametrize("path", COMMITTED, ids=os.path.basename)
def test_committed_file_loads_dumps_byte_identical(path):
    """loads -> dumps gives the file's bytes back in the port; both
    packages parse it to the same strategy and digest it alike."""
    with open(path, "rb") as f:
        data = f.read()
    port = port_proto.load_strategy_file(path)
    assert port_proto.dumps(port) == data
    ref = jax_proto.loads(data)
    assert same_strategy(ref, port)
    assert port_proto.strategy_digest(port) == \
        jax_proto.strategy_digest(ref)


@pytest.mark.parametrize("block", range(4))
def test_random_strategies_dumps_and_digest_equal_jax(block):
    """200 seeded random strategies (50 a block): the port's dumps is
    the JAX package's, byte for byte; loads gives the strategy back in
    both; strategy_digest agrees, also with ops left unassigned."""
    rng = random.Random(0xFF + block)
    for case in range(50):
        ref = _rand_strategy(rng)
        port = to_port(ref)
        blob = jax_proto.dumps(ref)
        assert port_proto.dumps(port) == blob, (block, case)
        assert same_strategy(port_proto.loads(blob), port)
        with_absent = dict(ref, unplaced_op=None)
        assert port_proto.strategy_digest(
            dict(port, unplaced_op=None)) == \
            jax_proto.strategy_digest(with_absent)


def test_packed_and_defaulted_fields_parse_alike():
    """A file with packed repeated fields and no device_ids parses to
    the same strategy in both packages (device_ids default to
    range(parts))."""
    def varint(out, v):
        jax_proto._write_varint(out, v)

    op = io.BytesIO()
    varint(op, (1 << 3) | 2)
    varint(op, 2)
    op.write(b"fc")
    varint(op, (2 << 3) | 0)
    varint(op, 0)
    packed = io.BytesIO()
    for d in (1, 4):
        varint(packed, d)
    varint(op, (3 << 3) | 2)
    varint(op, len(packed.getvalue()))
    op.write(packed.getvalue())
    body = op.getvalue()
    top = io.BytesIO()
    varint(top, (1 << 3) | 2)
    varint(top, len(body))
    top.write(body)
    data = top.getvalue()
    _same_outcome(data)
    assert port_proto.loads(data)["fc"].device_ids == (0, 1, 2, 3)


def test_every_truncation_same_outcome():
    """Every proper prefix of a file: the same StrategyParseError text in
    both packages, or the same parsed prefix."""
    rng = random.Random(3)
    data = jax_proto.dumps(_rand_strategy(rng))
    with open(COMMITTED[2], "rb") as f:
        nmt = f.read()
    for blob in (data, nmt):
        for cut in range(len(blob)):
            _same_outcome(blob[:cut])


def test_corrupted_bytes_same_outcome():
    """300 files with 1-4 bytes overwritten: the same outcome."""
    rng = random.Random(11)
    base = jax_proto.dumps(_rand_strategy(rng))
    for _ in range(300):
        data = bytearray(base)
        for _ in range(rng.randint(1, 4)):
            data[rng.randrange(len(data))] = rng.randrange(256)
        _same_outcome(bytes(data))


@pytest.mark.parametrize("case", ["varint", "overrun", "duplicate",
                                  "precision", "device_type", "utf8",
                                  "top_level"])
def test_malformed_file_same_error(case):
    def varint(out, v):
        jax_proto._write_varint(out, v)

    def wrap(body):
        top = io.BytesIO()
        varint(top, (1 << 3) | 2)
        varint(top, len(body))
        top.write(body)
        return top.getvalue()

    def op(field, value):
        out = io.BytesIO()
        varint(out, (1 << 3) | 2)
        varint(out, 2)
        out.write(b"fc")
        varint(out, (field << 3) | 0)
        varint(out, value)
        return out.getvalue()

    one = jax_proto.dumps({"fc": jax_config.ParallelConfig(
        dims=(2, 1), device_ids=(0, 1))})
    data = {
        "varint": b"\x80",
        "overrun": b"\x0a\x64\x0a\x01",
        "duplicate": one + one,
        "precision": wrap(op(6, 9)),
        "device_type": wrap(op(2, 7)),
        "utf8": wrap(b"\x0a\x02\xff\xfe"),
        "top_level": b"\x10\x01",
    }[case]
    kind, msg = _parse_error(port_proto, data)
    assert kind == "error"
    assert msg == _parse_error(jax_proto, data)[1]
    assert msg.startswith("strategy file byte ")


def test_precision_field_written_only_when_set():
    """Field 6 is written for a bf16 or f32 pin and not for the default,
    so a strategy without pins has the bytes of one written without the
    field; both packages write the same bytes."""
    pc = port_config.ParallelConfig(dims=(2, 1), device_ids=(0, 1))
    plain = port_proto.dumps({"fc": pc})
    assert bytes([6 << 3]) not in plain
    for tok in ("bf16", "f32"):
        pinned = port_config.ParallelConfig(dims=(2, 1), device_ids=(0, 1),
                                            precision=tok)
        blob = port_proto.dumps({"fc": pinned})
        assert len(blob) == len(plain) + 2
        assert port_proto.loads(blob)["fc"].precision == tok
        assert blob == jax_proto.dumps({"fc": jax_config.ParallelConfig(
            dims=(2, 1), device_ids=(0, 1), precision=tok)})


@pytest.mark.parametrize("args", [(1, 1, 4), (1, 1, 8), (2, 2, 24),
                                  (4, 2, 3)])
def test_dlrm_generators_same_bytes(args):
    """Both generators, the homogeneous (gpus per node, nodes, tables)
    and the hetero (gpus, cpus, tables), write the same bytes in both
    packages."""
    a, b, n = args
    assert port_proto.dumps(port_gen.generate_dlrm_strategy(
        a, b, num_embeddings=n)) == jax_proto.dumps(
        jax_gen.generate_dlrm_strategy(a, b, num_embeddings=n))
    assert port_proto.dumps(port_gen.generate_dlrm_hetero_strategy(
        a, b, num_embeddings=n)) == jax_proto.dumps(
        jax_gen.generate_dlrm_hetero_strategy(a, b, num_embeddings=n))


@pytest.mark.parametrize("argv", [[], ["--gpu", "4", "--node", "2"],
                                  ["--hetero", "--emb", "4"],
                                  ["--hetero", "--gpu", "2", "--cpu", "2"]])
def test_dlrm_gen_main_writes_the_same_file(tmp_path, monkeypatch, capsys,
                                            argv):
    """``python -m flexflow_tpu_torch.strategy.dlrm_gen`` writes the file
    the JAX package's entry writes, under the same name."""
    out = {}
    for pkg, gen in (("jax", jax_gen), ("port", port_gen)):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        gen.main(list(argv))
        (name,) = os.listdir(d)
        out[pkg] = (name, (d / name).read_bytes())
    assert out["port"] == out["jax"]
    assert capsys.readouterr().out.count("wrote ") == 2


def test_save_and_load_strategy_file(tmp_path):
    s = to_port(jax_gen.generate_dlrm_hetero_strategy(1, 1, 4))
    path = str(tmp_path / "s.pb")
    port_proto.save_strategy_file(path, s)
    assert same_strategy(port_proto.load_strategy_file(path), s)
    assert same_strategy(jax_proto.load_strategy_file(path), s)
