"""Arithmetic the per-layer metric readers share.  Each reader in
``metrics/`` picks what it needs from a :class:`~portbench.cell.Run`
and returns None where the run holds nothing for it to read (an
untraced run, a window with no such kernel), never 0 for a share of a
roofline or of a peak."""

from __future__ import annotations

from typing import Optional

from . import flops, peaks

# cuBLAS and cuBLASLt matrix products on the H100 (the SIMT and tensor
# core GEMMs, the nvjet kernels, split-K's reduction)
GEMM_KERNELS = r"gemm|nvjet|splitkreduce"
FLASH_KERNELS = r"flash_fwd|flash_bwd"
LAYERNORM_KERNELS = r"(^|[^a-z_])layernorm_kernel"

FLASH_COUNTERS = {
    r"flash_fwd": ("flexflow_tpu_torch.ops.cuda_attention:"
                   "flash_attention_forward.launches", 1),
    # one backward call launches three kernels (Dvec, dK/dV, dQ)
    r"flash_bwd": ("flexflow_tpu_torch.ops.cuda_attention:"
                   "flash_attention_backward.launches", 3),
}
LAYERNORM_COUNTERS = {
    LAYERNORM_KERNELS: ("flexflow_tpu_torch.ops.cuda_norm:"
                        "fused_layernorm.launches", 1),
}

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def compute_bytes(run) -> int:
    """Bytes of an element in the configuration's compute dtype."""
    return DTYPE_BYTES[run.cell.config["precision"]["compute"]]


def share(least_s: float, took_s: float) -> Optional[float]:
    """``least_s`` over ``took_s`` in percent; None where nothing ran."""
    if took_s <= 0.0 or least_s <= 0.0:
        return None
    return 100.0 * least_s / took_s


def device_idle_pct(run) -> Optional[float]:
    """Share of the traced window in which no device operation ran."""
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu_pct(run) -> Optional[float]:
    """The model FLOP the driver counted in the window over the window's
    seconds, as a share of the bf16 tensor-core peak."""
    flop = run.work.get("model_flop", 0.0)
    if flop <= 0.0 or run.window_s <= 0.0:
        return None
    return 100.0 * flop / run.window_s / peaks.BF16_FLOPS


def layernorm_roofline_pct(run) -> Optional[float]:
    """Least bytes time of the window's LayerNorm work over the device
    time of the fused LayerNorm kernel in the window.  The work is
    ``run.work["layernorm_rows"]`` rows of the model width in and out in
    the compute dtype, and each launch's float32 scale and bias."""
    tr = run.trace
    rows = run.work.get("layernorm_rows", 0)
    if tr is None or rows <= 0:
        return None
    launches = tr.kernel_count(LAYERNORM_KERNELS)
    elt = compute_bytes(run)
    d = run.cell.geometry["d_model"]
    nbytes = (flops.layernorm_bytes(rows, d, elt, elt)
              + (launches - 1) * 2 * d * 4)
    return share(nbytes / peaks.HBM_BYTES,
                 tr.kernel_seconds(LAYERNORM_KERNELS))
