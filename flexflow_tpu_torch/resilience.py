"""Checkpoint integrity and atomic publish, the port's copy of the
device-free half of ``flexflow_tpu/resilience.py`` (with the two file
helpers ``flexflow_tpu/model.py`` keeps beside it and
``parallel/elastic.py``'s ``_step_checkpoints``).

* **Checkpoint manifest + verification** — ``build_manifest`` embeds a
  per-array CRC32 table (plus step, format version and the topology the
  file was saved under) under the ``meta:manifest`` key of the
  checkpoint ``.npz``; ``verify_checkpoint`` re-reads a file end to end
  and checks every CRC.
* **Atomic publish** — ``_atomic_savez`` writes through a
  ``*.tmp.npz`` and a rename, so a kill mid-write never leaves a
  truncated file at the published name; ``_cleanup_stale_tmps`` sweeps
  the orphans such a kill leaves, and ``_prune_step_family`` keeps the
  newest ``keep_last`` files of a ``<name>_step<N>.npz`` family.

The file format is the JAX package's, so either package verifies and
loads the other's checkpoints.  numpy and the standard library only.
Heartbeats and the elastic resume come with the multi-device layer, and
the fault hooks with the tooling; until then a skipped checkpoint is
reported through ``warnings.warn``.
"""

from __future__ import annotations

import json
import os
import re
import warnings
import zipfile
import zlib
from typing import Dict, Optional

import numpy as np

#: npz key holding the JSON manifest (kept in ``meta:`` space alongside
#: ``meta:step`` so param/opt key enumeration is unaffected)
MANIFEST_KEY = "meta:manifest"
#: v1: per-array CRC32 table + step.  v2 adds the topology the
#: checkpoint was saved under — ``mesh_shape``/``num_devices``/
#: ``process_count``/``strategy_digest``.  v1 and manifest-less archives
#: keep verifying unchanged.
MANIFEST_VERSION = 2

# "<anything>_step<N>.npz" — the family naming convention step-numbered
# checkpoints use; retention and stale-tmp sweeps operate on it
_STEP_FAMILY_RE = re.compile(r"^(?P<family>.+_step)\d+\.npz$")


class CorruptNpzError(RuntimeError):
    """A ``.npz`` archive (checkpoint or dataset) that cannot be read —
    truncated, bit-rotted, or failing its manifest CRCs."""


class CorruptCheckpointError(CorruptNpzError):
    """A checkpoint that failed verification; the raiser names the path
    and the fallback (``latest_valid_checkpoint``)."""


# ----------------------------------------------------------------------
# atomic publish
# ----------------------------------------------------------------------
def _atomic_savez(final: str, arrays: Dict[str, np.ndarray]) -> str:
    """Write ``arrays`` to ``final`` (.npz) via tmp + rename: a crash or
    kill mid-write never leaves a truncated file at the published name.
    The tmp keeps the ``.npz`` suffix because ``np.savez`` appends it to
    suffix-less paths."""
    assert final.endswith(".npz"), final
    tmp = final[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, final)
    return final


def _cleanup_stale_tmps(final: str) -> None:
    """Remove orphaned ``*.tmp.npz`` siblings of ``final`` (a writer
    killed mid-``np.savez`` leaves them behind).  Scoped to the same
    checkpoint family (``<name>_step<N>`` siblings, or the exact name
    for step-less paths) so unrelated tmp files are untouched."""
    d = os.path.dirname(final) or "."
    base = os.path.basename(final)
    m = _STEP_FAMILY_RE.match(base)
    if m is not None:
        pat = re.compile(re.escape(m.group("family")) + r"\d+\.tmp\.npz$")
    else:
        pat = re.compile(re.escape(base[:-len(".npz")]) + r"\.tmp\.npz$")
    try:
        names = os.listdir(d)
    except OSError:
        return
    for n in names:
        if pat.fullmatch(n):
            try:
                os.remove(os.path.join(d, n))
            except OSError:
                pass


def _step_checkpoints(directory: str, prefix: str):
    """``(step, path)`` for every ``<prefix>_step<N>.npz``, newest first
    (unpublished ``*.tmp.npz`` partial writes excluded)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    found = []
    for n in names:
        if not (n.startswith(prefix + "_step") and n.endswith(".npz")):
            continue
        if n.endswith(".tmp.npz"):
            continue
        try:
            step = int(n[len(prefix + "_step"):-len(".npz")])
        except ValueError:
            continue
        found.append((step, os.path.join(directory, n)))
    found.sort(key=lambda sp: sp[0], reverse=True)
    return found


def _prune_step_family(final: str, keep_last: int) -> None:
    """Retention for step-numbered checkpoint families: after ``final``
    is published, keep only the newest ``keep_last`` of its
    ``<name>_step<N>.npz`` siblings.  No-op for step-less names."""
    m = _STEP_FAMILY_RE.match(os.path.basename(final))
    if m is None:
        return
    prefix = m.group("family")[:-len("_step")]
    d = os.path.dirname(final) or "."
    for _, p in _step_checkpoints(d, prefix)[max(1, int(keep_last)):]:
        try:
            os.remove(p)
        except OSError:
            pass


# ----------------------------------------------------------------------
# checkpoint manifest
# ----------------------------------------------------------------------
def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def build_manifest(arrays: Dict[str, np.ndarray], step: int,
                   mesh_shape: Optional[Dict[str, int]] = None,
                   num_devices: Optional[int] = None,
                   process_count: Optional[int] = None,
                   strategy_digest: Optional[str] = None) -> str:
    """JSON manifest for a checkpoint's arrays: per-array CRC32 + shape +
    dtype, the step, and a format version — plus (v2) the topology the
    checkpoint was saved under, when the writer knows it.  ``None``
    omits a topology field."""
    man: Dict = {
        "format_version": MANIFEST_VERSION,
        "step": int(step),
        "arrays": {
            k: {"crc32": _crc(np.asarray(v)),
                "shape": list(np.asarray(v).shape),
                "dtype": str(np.asarray(v).dtype)}
            for k, v in arrays.items()},
    }
    if mesh_shape is not None:
        man["mesh_shape"] = {str(a): int(s) for a, s in mesh_shape.items()}
    if num_devices is not None:
        man["num_devices"] = int(num_devices)
    if process_count is not None:
        man["process_count"] = int(process_count)
    if strategy_digest is not None:
        man["strategy_digest"] = str(strategy_digest)
    return json.dumps(man, sort_keys=True)


def manifest_meta(data: Dict[str, np.ndarray]) -> Optional[Dict]:
    """The parsed manifest of already-loaded checkpoint ``data`` with
    the v2 topology fields normalized: ``format_version``/``step``
    always present, ``mesh_shape``/``num_devices``/``process_count``/
    ``strategy_digest`` present-or-None.  None for manifest-less
    archives; an unreadable manifest raises."""
    if MANIFEST_KEY not in data:
        return None
    try:
        man = json.loads(str(np.asarray(data[MANIFEST_KEY])))
        meta = {"format_version": int(man["format_version"]),
                "step": int(man["step"])}
        mesh = man.get("mesh_shape")
        meta["mesh_shape"] = ({str(a): int(s) for a, s in mesh.items()}
                              if isinstance(mesh, dict) else None)
        for k in ("num_devices", "process_count"):
            v = man.get(k)
            meta[k] = int(v) if v is not None else None
        d = man.get("strategy_digest")
        meta["strategy_digest"] = str(d) if d is not None else None
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise CorruptCheckpointError(
            f"checkpoint manifest is unreadable "
            f"({type(e).__name__}: {e})") from e
    return meta


def verify_manifest(data: Dict[str, np.ndarray], path: str = "<npz>") -> None:
    """Check loaded checkpoint ``data`` against its embedded manifest.
    Manifest-less archives pass (readability was already proven by
    loading them).  Raises :class:`CorruptCheckpointError` on any
    mismatch."""
    if MANIFEST_KEY not in data:
        return
    try:
        man = json.loads(str(np.asarray(data[MANIFEST_KEY])))
        version = int(man["format_version"])
        entries = man["arrays"]
    except (ValueError, KeyError, TypeError) as e:
        raise CorruptCheckpointError(
            f"checkpoint {path!r} has an unreadable manifest "
            f"({type(e).__name__}: {e})") from e
    if version > MANIFEST_VERSION:
        raise CorruptCheckpointError(
            f"checkpoint {path!r} has manifest format_version {version}; "
            f"this build understands <= {MANIFEST_VERSION}")
    payload = {k: v for k, v in data.items() if k != MANIFEST_KEY}
    if set(entries) != set(payload):
        raise CorruptCheckpointError(
            f"checkpoint {path!r} manifest names "
            f"{len(entries)} arrays but the archive holds {len(payload)}")
    for k, v in payload.items():
        if _crc(v) != int(entries[k]["crc32"]):
            raise CorruptCheckpointError(
                f"checkpoint {path!r} failed CRC verification for "
                f"array {k!r} — the file is corrupt; resume from the "
                f"next-newest valid checkpoint (latest_valid_checkpoint)")


def read_npz_verified(path: str, what: str = "checkpoint"
                      ) -> Dict[str, np.ndarray]:
    """Read a whole ``.npz`` into host arrays, translating the opaque
    low-level failures of a truncated/corrupt archive
    (``zipfile.BadZipFile``, bare ``ValueError``/``OSError``) into a
    :class:`CorruptCheckpointError` that names the path, then checking
    the embedded manifest when present."""
    try:
        with np.load(path, allow_pickle=False) as f:
            data = {k: np.asarray(f[k]) for k in f.files}
    except (zipfile.BadZipFile, zlib.error, ValueError, OSError, EOFError,
            KeyError) as e:
        raise CorruptCheckpointError(
            f"{what} {path!r} is corrupt or truncated "
            f"({type(e).__name__}: {e}); resume from the next-newest "
            f"valid file via latest_valid_checkpoint()") from e
    verify_manifest(data, path)
    return data


def iter_valid_checkpoints(directory: str, prefix: str = "elastic"):
    """Yield ``(step, path, data)`` for every verified checkpoint in
    ``directory`` newest-first (one full read + CRC pass each), warning
    with the path, step and reason for every corrupt or truncated
    candidate it skips."""
    for step, path in _step_checkpoints(directory, prefix):
        try:
            data = read_npz_verified(path, what="checkpoint")
        except CorruptNpzError as e:
            warnings.warn(f"checkpoint_skipped: {path} (step {step}): "
                          f"{type(e).__name__}: {e}")
            continue
        yield step, path, data


def latest_valid_checkpoint(directory: str, prefix: str = "elastic"
                            ) -> Optional[str]:
    """The newest ``<prefix>_step<N>.npz`` in ``directory`` that
    verifies, or None; corrupt newer files are skipped with a warning."""
    for _, path, _data in iter_valid_checkpoints(directory, prefix):
        return path
    return None


def verify_checkpoint(path: str) -> bool:
    """True iff ``path`` is a readable checkpoint whose manifest (when
    present) verifies.  Reads the whole file: a verdict cheaper than
    reading cannot rule out truncation."""
    try:
        read_npz_verified(path)
        return True
    except CorruptNpzError:
        return False
