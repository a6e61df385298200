"""Int8 weight-only quantization for dense serving, the port of
``flexflow_tpu/serving/quantize.py``.

Scheme: per-OUTPUT-channel symmetric quantization of the eligible
matmul kernels.  For a ``(out, in)`` Linear kernel ``w``, output row
``c`` gets ``scale[c] = max|w[c, :]| / 127`` and ``q[c, :] =
rint(w[c, :] / scale[c])`` in int8.  Because the scale is per output
channel, ``x @ (q * scale).T == (x @ q.T) * scale``, so the
dequantization multiplies the product (``ops.common.dequant_matmul``)
and the resident weight is the int8 tensor plus a float32 ``(out,)``
scale: about a quarter of the float32 bytes.

Quality bound: round to nearest gives ``|w - q * scale| <= scale / 2``
per channel, so the model-wide ``max_abs_err`` cannot exceed
``max(scale) / 2``.  The report carries both; the serving engine refuses
to warm up when ``bound_ok`` is False (a tripwire for a broken
quantizer, not a knob).

The quantizer is numpy on the host, as in the JAX package, so ``q`` and
``scale`` are bit-equal to that package's: ``np.rint`` rounds ties to
even, values clip to +-127, the scale is floored at float32 ``tiny`` (a
zero row quantizes to zeros) and the division runs in float32.

Eligibility (:func:`eligible_weights`) is the one predicate shared with
the memory accounting (:func:`quantized_params_bytes_delta`): 2-D
``Linear`` kernels that are not host-placed.  Biases, norm scales,
embeddings, attention projections and conv filters keep their dtype.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..ops.common import scale_param_name as scale_name

INT8_QMAX = 127

QUANT_MODES = ("", "int8")


def eligible_weights(layers) -> List[Tuple[Any, Any]]:
    """``[(op, weight), ...]`` of the kernels int8 quantization applies
    to: 2-D Linear kernels that are not host-placed.  Device-free (type
    and shape checks only)."""
    from ..ops.linear import Linear, host_placed
    out = []
    for op in layers:
        if not isinstance(op, Linear):
            continue
        if host_placed(getattr(op, "parallel_config", None)):
            # host-placed parameters keep the host-gather path
            continue
        w = getattr(op, "w_kernel", None)
        if w is not None and len(w.shape) == 2:
            out.append((op, w))
    return out


def eligible_weight_names(layers) -> frozenset:
    return frozenset(w.name for _, w in eligible_weights(layers))


def quantize_array(host: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                              float, float]:
    """Quantize one ``(out, in)`` float32 kernel: returns ``(q int8,
    scale float32 (out,), max_abs_err, error_bound)``."""
    host = np.asarray(host, np.float32)
    amax = np.max(np.abs(host), axis=1) if host.size else np.zeros(
        host.shape[0], np.float32)
    # a zero row quantizes to zeros exactly; the tiny floor avoids 0/0
    scale = np.maximum(amax / INT8_QMAX,
                       np.finfo(np.float32).tiny).astype(np.float32)
    q = np.clip(np.rint(host / scale[:, None]),
                -INT8_QMAX, INT8_QMAX).astype(np.int8)
    if host.size:
        err = float(np.max(np.abs(host - q.astype(np.float32)
                                  * scale[:, None])))
        bound = float(np.max(scale)) * 0.5
    else:
        err = bound = 0.0
    # one ulp of headroom: the bound is exact in real arithmetic, and
    # the float rounding of q * scale may add an ulp
    bound *= 1.0 + 1e-6
    return q, scale, err, bound


def quantize_params(model, mode: str = "int8"
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A quantized copy of ``model._params`` and the quality report
    (``FFModel.quantize_weights`` is the caller).  Each eligible kernel
    is replaced by its int8 tensor on the kernel's device, its float32
    scale beside it under ``scale_name(w)``; the new dict holds no
    reference to the float32 kernels."""
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r} "
                         f"(have {', '.join(m for m in QUANT_MODES if m)})")
    new_params: Dict[str, torch.Tensor] = dict(model._params)
    rows: List[Dict] = []
    max_err = 0.0
    bound = 0.0
    bytes_before = bytes_after = 0
    for op, w in eligible_weights(model.layers):
        arr = model._params.get(w.name)
        if arr is None:
            continue
        host = arr.detach().to("cpu", torch.float32).numpy()
        q, scale, err, wbound = quantize_array(host)
        new_params[w.name] = torch.from_numpy(q).to(arr.device)
        new_params[scale_name(w.name)] = torch.from_numpy(scale).to(
            arr.device)
        max_err = max(max_err, err)
        bound = max(bound, wbound)
        bytes_before += arr.numel() * arr.element_size()
        bytes_after += int(q.nbytes + scale.nbytes)
        rows.append({"op": op.name, "weight": w.name,
                     "shape": list(w.shape),
                     "scale_max": float(np.max(scale)) if scale.size
                     else 0.0,
                     "max_abs_err": err, "error_bound": wbound})
    report = {
        "mode": mode,
        "weights": rows,
        "max_abs_err": max_err,
        "error_bound": bound,
        "bound_ok": max_err <= bound or not rows,
        "bytes_before": bytes_before,
        "bytes_after": bytes_after,
    }
    return new_params, report


def _subaxis_sizes(mesh) -> Dict[str, int]:
    """The size of every axis name a spec entry can mention: canonical
    axes ("n") and their prime sub-axes ("n0", "n1", ...)."""
    out: Dict[str, int] = {}
    for a, size in mesh.sizes.items():
        out[a] = size
        for nm, f in zip(mesh.subaxes(a), mesh._subfactors[a]):
            out[nm] = f
    return out


def quantized_params_bytes_delta(layers, strategies, mesh) -> float:
    """Per-device byte change that int8 quantization applies to the
    float32 parameter bytes under a strategy on ``mesh`` (an
    ``AbstractMesh``): for every eligible kernel the float32 shard (4
    bytes an element over its placement's parts) leaves, the int8 shard
    (1 byte, same parts) and the replicated float32 scale (out x 4
    bytes on every device) arrive.  Unused until the fleet's memory gate
    is ported."""
    from ..parallel.sharding import param_spec
    sizes = _subaxis_sizes(mesh)
    delta = 0.0
    for op, w in eligible_weights(layers):
        pc = (strategies or {}).get(op.name)
        spec = param_spec(w, pc, mesh, on_fallback=lambda *a: None)
        parts = 1
        for entry in spec:
            if entry is None:
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            for nm in names:
                parts *= sizes.get(nm, 1)
        vol = 1
        for s in w.shape:
            vol *= int(s)
        delta -= vol * 4.0 / parts          # the float32 shard leaves
        delta += vol * 1.0 / parts          # the int8 shard arrives
        delta += int(w.shape[0]) * 4.0      # the replicated (out,) scale
    return delta


__all__ = ["eligible_weights", "eligible_weight_names", "quantize_array",
           "quantize_params", "quantized_params_bytes_delta",
           "scale_name", "INT8_QMAX", "QUANT_MODES"]
