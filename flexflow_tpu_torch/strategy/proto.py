"""Strategy-file I/O: the JAX package's ``strategy/proto.py``, byte for
byte the same wire format.

The reference's ``strategy.proto`` (proto2)::

    message Op { required string name = 1;
                 required DeviceType device_type = 2;   // GPU=0, CPU=1
                 repeated int32 dims = 3;               // innermost-first!
                 repeated int32 device_ids = 4;
                 repeated MemoryType memory_types = 5;
                 optional Precision precision = 6; }
    message Strategy { repeated Op ops = 1; }

Field 6 is the per-op precision: 0 follows ``FFConfig.compute_dtype``
(and is what a file without the field parses as), 1 is bf16, 2 is f32.
The writer emits it only when it is not the default, so a strategy
without overrides writes the bytes a writer without the field wrote.

The proto2 wire format is written by hand (varints and length-delimited
fields), with no protobuf runtime.  The file stores ``dims``
innermost-first (the sample dim last); ``ParallelConfig.dims`` is
outermost-first, so the dims are reversed at this boundary.  Readers take
packed and unpacked repeated fields; the writer emits unpacked ones.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Tuple

from ..config import DeviceType, MemoryType, ParallelConfig

_WIRE_VARINT = 0
_WIRE_LEN = 2

# Op.precision wire enum (field 6) <-> ParallelConfig.precision token
_PRECISION_FROM_WIRE = {0: "", 1: "bf16", 2: "f32"}
_PRECISION_TO_WIRE = {"": 0, "bf16": 1, "f32": 2}


class StrategyParseError(ValueError):
    """Malformed/truncated strategy file.  Always carries the absolute
    file offset and the field being parsed — a truncated ``.pb`` must
    fail with WHERE, not an ``IndexError`` from varint internals."""


def _fail(base: int, pos: int, field: str, what: str) -> None:
    raise StrategyParseError(
        f"strategy file byte {base + pos}: {what} while reading {field}")


def _read_varint(buf: memoryview, pos: int, base: int = 0,
                 field: str = "varint") -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            _fail(base, pos, field, "truncated varint")
        if shift > 63:
            _fail(base, pos, field, "varint longer than 64 bits")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _write_varint(out: io.BytesIO, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _checked_len(buf: memoryview, pos: int, base: int,
                 field: str) -> Tuple[int, int]:
    """Length prefix + bounds check: the declared span must lie inside
    the buffer."""
    ln, pos = _read_varint(buf, pos, base, field + " length")
    if pos + ln > len(buf):
        _fail(base, pos, field,
              f"declared length {ln} overruns the remaining "
              f"{len(buf) - pos} bytes")
    return ln, pos


def _parse_repeated_int32(buf: memoryview, pos: int, wire: int,
                          dest: List[int], base: int, field: str) -> int:
    if wire == _WIRE_VARINT:
        v, pos = _read_varint(buf, pos, base, field)
        dest.append(v)
    elif wire == _WIRE_LEN:  # packed
        ln, pos = _checked_len(buf, pos, base, field + " (packed)")
        end = pos + ln
        while pos < end:
            v, pos = _read_varint(buf, pos, base, field + " (packed)")
            dest.append(v)
    else:
        _fail(base, pos, field, f"bad wire type {wire} for repeated int32")
    return pos


def _parse_op(data: bytes, base: int = 0) -> Tuple[str, ParallelConfig]:
    """Parse one Op message.  ``base`` is the message's absolute offset in
    the file, so every parse error names the real file position."""
    buf = memoryview(data)
    pos = 0
    name = ""
    device_type = 0
    dims: List[int] = []
    device_ids: List[int] = []
    memory_types: List[int] = []
    precision = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos, base, "Op tag")
        field, wire = tag >> 3, tag & 7
        if field == 1:
            ln, pos = _checked_len(buf, pos, base, "Op.name")
            try:
                name = bytes(buf[pos:pos + ln]).decode("utf-8")
            except UnicodeDecodeError as e:
                # e.start is relative to the sliced name bytes; report
                # the absolute file offset like every other parse error
                raise StrategyParseError(
                    f"strategy file byte {base + pos + e.start}: invalid "
                    f"UTF-8 while reading Op.name") from e
            pos += ln
        elif field == 2:
            device_type, pos = _read_varint(buf, pos, base,
                                            "Op.device_type")
        elif field == 3:
            pos = _parse_repeated_int32(buf, pos, wire, dims, base,
                                        "Op.dims")
        elif field == 4:
            pos = _parse_repeated_int32(buf, pos, wire, device_ids, base,
                                        "Op.device_ids")
        elif field == 5:
            pos = _parse_repeated_int32(buf, pos, wire, memory_types, base,
                                        "Op.memory_types")
        elif field == 6:
            at = pos
            precision, pos = _read_varint(buf, pos, base, "Op.precision")
            if precision not in _PRECISION_FROM_WIRE:
                raise StrategyParseError(
                    f"strategy file byte {base + at}: op {name!r}: "
                    f"unknown Op.precision value {precision} (want 0="
                    f"follow, 1=bf16, 2=f32)")
        else:  # skip unknown
            fld = f"unknown field {field}"
            if wire == _WIRE_VARINT:
                _, pos = _read_varint(buf, pos, base, fld)
            elif wire == _WIRE_LEN:
                ln, pos = _checked_len(buf, pos, base, fld)
                pos += ln
            else:
                _fail(base, pos, fld, f"unknown wire type {wire}")
    try:
        pc = ParallelConfig(
            device_type=DeviceType(device_type),
            dims=tuple(reversed(dims)),  # file is innermost-first
            device_ids=tuple(device_ids) or tuple(
                range(max(1, _prod(dims)))),
            memory_types=tuple(MemoryType(m) for m in memory_types),
            precision=_PRECISION_FROM_WIRE[precision],
        )
    except ValueError as e:  # bad enum value: say which op, keep offset
        raise StrategyParseError(
            f"strategy file byte {base}: op {name!r}: {e}") from e
    return name, pc


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


def loads(data: bytes) -> Dict[str, ParallelConfig]:
    """Parse a Strategy message.  Malformed/truncated input raises
    :class:`StrategyParseError` (a ValueError) naming the absolute byte
    offset and field; duplicate op names are rejected — silently keeping
    the LAST entry (the old dict-overwrite behavior) would let a
    hand-edited file drop a strategy without a trace."""
    buf = memoryview(data)
    pos = 0
    out: Dict[str, ParallelConfig] = {}
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos, 0, "Strategy tag")
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == _WIRE_LEN:
            ln, pos = _checked_len(buf, pos, 0, "Strategy.ops entry")
            name, pc = _parse_op(bytes(buf[pos:pos + ln]), base=pos)
            if name in out:
                raise StrategyParseError(
                    f"strategy file byte {pos}: duplicate op name "
                    f"{name!r} (an earlier entry would be silently "
                    f"overwritten)")
            pos += ln
            out[name] = pc
        else:
            _fail(0, pos, "Strategy",
                  f"unexpected top-level field {field}/{wire}")
    return out


def dumps(strategies: Dict[str, ParallelConfig]) -> bytes:
    top = io.BytesIO()
    for name, pc in strategies.items():
        op = io.BytesIO()
        nb = name.encode("utf-8")
        _write_varint(op, (1 << 3) | _WIRE_LEN)
        _write_varint(op, len(nb))
        op.write(nb)
        _write_varint(op, (2 << 3) | _WIRE_VARINT)
        _write_varint(op, int(pc.device_type))
        for d in reversed(pc.dims):  # back to innermost-first
            _write_varint(op, (3 << 3) | _WIRE_VARINT)
            _write_varint(op, int(d))
        for d in pc.device_ids:
            _write_varint(op, (4 << 3) | _WIRE_VARINT)
            _write_varint(op, int(d))
        for m in pc.memory_types:
            _write_varint(op, (5 << 3) | _WIRE_VARINT)
            _write_varint(op, int(m))
        # emitted only when non-default: a strategy without precision
        # overrides round-trips byte-identically to a pre-extension
        # writer (strategy_digest and shipped .pbs unchanged)
        prec = _PRECISION_TO_WIRE[getattr(pc, "precision", "")]
        if prec:
            _write_varint(op, (6 << 3) | _WIRE_VARINT)
            _write_varint(op, prec)
        body = op.getvalue()
        _write_varint(top, (1 << 3) | _WIRE_LEN)
        _write_varint(top, len(body))
        top.write(body)
    return top.getvalue()


def load_strategy_file(path: str) -> Dict[str, ParallelConfig]:
    with open(path, "rb") as f:
        return loads(f.read())


def save_strategy_file(path: str,
                       strategies: Dict[str, ParallelConfig]) -> None:
    with open(path, "wb") as f:
        f.write(dumps(strategies))


def strategy_digest(strategies: Dict[str, Optional[ParallelConfig]]) -> str:
    """Stable short digest of a resolved strategy assignment, recorded
    in checkpoint manifests (resilience.build_manifest) so a resume can
    tell whether the checkpoint was trained under the SAME parallel
    strategy it is about to run — a mismatch is what triggers the
    reshard-on-resume path (docs/elastic.md "Resharding").  Ops without
    a config hash as such (the data-parallel default), name order is
    canonicalized, and the wire encoding of :func:`dumps` supplies the
    value normalization, so the digest is independent of dict insertion
    order and of how the strategy was produced (searched / imported /
    hand-built)."""
    import hashlib
    resolved = {n: pc for n, pc in sorted(strategies.items())
                if pc is not None}
    blob = dumps(resolved)
    absent = ",".join(n for n, pc in sorted(strategies.items())
                      if pc is None)
    h = hashlib.sha256(blob + b"\x00" + absent.encode("utf-8"))
    return h.hexdigest()[:16]
