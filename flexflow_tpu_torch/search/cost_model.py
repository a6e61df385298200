"""The JAX package's analytic cost model (``search/cost_model.py``) with
the port's device: one NVIDIA H100 SXM.

The time half: :func:`op_compute_time` is one partition's roofline
(max(compute, memory) + a launch), :func:`transfer_time` a point-to-point
copy and :func:`allreduce_time` a ring allreduce, hierarchical across
hosts.  The memory half: :func:`op_memory_bytes` /
:func:`op_memory_components` account one op's per-device resident bytes
under a strategy; the simulator sums them into a step's high-water mark,
and the verifier and the search hold it, times
:attr:`DeviceSpec.temp_factor`, against :attr:`DeviceSpec.hbm_capacity`
(FF108).

The JAX package's model carries constants measured on a TPU (a conv's
lane fill, a strided dgrad's and a max-pool backward's lowering, XLA's
temporaries).  Here each is a :class:`DeviceSpec` field: the H100's spec
holds the neutral value or the port's own measurement, and a spec built
from the JAX package's values reproduces its numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..config import PRECISION_DTYPES
from ..op import Op, OpType

# The measured ratio of eager torch's peak allocation over a training
# step (``torch.cuda.max_memory_allocated``) to the analytic high-water
# ``Simulator.peak_memory_bytes`` charges the same step: autograd's
# saved tensors and temporaries beyond the model's activations.  The
# memory check multiplies the analytic peak by it.  The largest ratio
# over the 15 full-width training steps ``chip_smoke.py`` measures, on an
# NVIDIA H100 80GB HBM3 at 700 W: NMT's step (bf16, batch 256; its LSTM
# loops keep every time step's tensors), 6.699 GiB allocated against
# 2.217 GiB analytic.  BERT-base reads 2.68, the CNNs 1.23-1.87.
TEMP_FACTOR = 3.0216

# The launch floor: an empty kernel on a 16-block grid, timed with CUDA
# events by ``chip_smoke.py``'s LayerNorm phase on an NVIDIA H100 80GB
# HBM3 at 700 W (0.00187 ms; the search phase prints this run's floor
# beside it).
H100_KERNEL_LAUNCH = 1.87e-6


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Per-device capability model.  The field names are the JAX
    package's: ``mxu_flops`` is the matrix (tensor-core) rate,
    ``vpu_flops`` the elementwise rate, ``ici_bw`` the link between the
    devices of one host, ``dcn_bw`` a device's link between hosts,
    ``ici_latency`` one transfer's fixed cost, ``kernel_launch`` one
    kernel's.  The defaults of the fields after the first five are the
    H100's (sources at :data:`H100_SXM_SPEC`).

    The corrections, each 1.0 or 0 where the device needs none:
    ``conv_lane_fill`` — input channels a conv needs to fill its
    contraction (0: none); ``strided_dgrad_law`` — k in a stride-s
    dgrad's ``1 + k s^2 / 4`` backward multiplier (0: none);
    ``maxpool_bwd_factor`` — a max-pool backward's multiplier;
    ``f32_matmul_scale`` — the matrix rate of an op pinned to float32
    over ``mxu_flops``; ``temp_factor`` — the measured peak over the
    analytic high-water the memory check multiplies by."""

    mxu_flops: float
    vpu_flops: float
    hbm_bw: float
    hbm_capacity: float
    ici_bw: float
    dcn_bw: float = 50e9
    ici_latency: float = H100_KERNEL_LAUNCH
    kernel_launch: float = H100_KERNEL_LAUNCH
    conv_lane_fill: int = 0
    strided_dgrad_law: float = 0.0
    maxpool_bwd_factor: float = 1.0
    f32_matmul_scale: float = 67e12 / 989e12
    temp_factor: float = TEMP_FACTOR


# NVIDIA H100 SXM5 80GB, NVIDIA's H100 Tensor Core GPU data sheet (dense
# rates, without sparsity, at the 700 W limit): 989 TFLOP/s bf16 tensor
# core, 67 TFLOP/s float32 outside the tensor cores (the port's float32
# GEMMs: TF32 stays off, so an op pinned to f32 runs at 67/989 of the
# bf16 rate), 3.35 TB/s HBM3, 80 GB, NVLink 900 GB/s.  ``dcn_bw``: the
# NVIDIA DGX H100 data sheet's one 400 Gb/s ConnectX-7 port a GPU, 50
# GB/s.  ``kernel_launch``: the launch floor measured on the card
# (:data:`H100_KERNEL_LAUNCH`).  ``ici_latency``: no data sheet gives an
# NVLink transfer's latency and one card cannot measure a hop between
# two; the field charges the same one-card launch floor, since a
# transfer is at least one enqueued copy or kernel (a lower bound).  The
# corrections are neutral: the port's convs run cuDNN and its max-pool
# backward the hand-written kernel, for which no device measured an
# excess; ``temp_factor`` is the port's own measurement.
H100_SXM_SPEC = DeviceSpec(mxu_flops=989e12, vpu_flops=67e12,
                           hbm_bw=3.35e12, hbm_capacity=80e9,
                           ici_bw=900e9)

_KIND_TO_SPEC = {
    "NVIDIA H100 80GB HBM3": H100_SXM_SPEC,
}

DEFAULT_SPEC = H100_SXM_SPEC


def spec_for_device(device_kind: str | None = None) -> DeviceSpec:
    """The DeviceSpec of the attached card, by
    ``torch.cuda.get_device_name()``; with no card, or a card the table
    does not know, :data:`DEFAULT_SPEC`, so device-free runs are
    deterministic."""
    if device_kind is None:
        import torch
        if not torch.cuda.is_available():
            return DEFAULT_SPEC
        device_kind = torch.cuda.get_device_name(0)
    return _KIND_TO_SPEC.get(device_kind, DEFAULT_SPEC)


def precision_dtype_bytes(precision: str, default: int) -> int:
    """Activation byte width of one op under a strategy's precision
    token: ``""`` follows the session dtype (``default`` — the
    bit-identical path), ``"bf16"``/``"f32"`` force 2/4.  THE one
    precision→bytes rule shared by the time roofline, the FF108/FF121
    memory accounting and the SimSession's incremental cache."""
    if precision == "bf16":
        return 2
    if precision == "f32":
        return 4
    return default


# ops whose arithmetic runs outside the matrix units
_VPU_OPS = {
    OpType.ELEMENT_UNARY, OpType.ELEMENT_BINARY, OpType.SOFTMAX,
    OpType.BATCHNORM, OpType.LAYERNORM, OpType.RMSNORM, OpType.DROPOUT,
    OpType.POOL2D, OpType.EMBEDDING, OpType.CONCAT, OpType.SPLIT,
    OpType.FLAT, OpType.RESHAPE, OpType.TRANSPOSE,
}


def op_compute_time(op: Op, part_degrees: Tuple[int, ...],
                    spec: DeviceSpec = DEFAULT_SPEC,
                    dtype_bytes: int = 2, backward: bool = False,
                    flash_attention=None, precision: str = "",
                    device="cuda",
                    compute_dtype: str = "bfloat16") -> float:
    """Roofline time for ONE partition of ``op`` under the given degrees:
    max(compute, memory) + one launch.  Backward is 2x the forward's
    FLOPs and bytes (dgrad + wgrad), times the op's
    ``backward_overhead`` on this spec.

    ``precision`` is the op's strategy dtype override: ``"bf16"``/
    ``"f32"`` charge its activation traffic at 2/4 bytes, and an op on
    the matrix units pinned to ``"f32"`` runs at ``spec.f32_matmul_scale``
    of the rate.  The default ``""`` leaves every term as the caller's
    ``dtype_bytes`` implies (the charge is one-sided, as in the JAX
    package: an unpinned op keeps the full rate).  ``device`` and
    ``compute_dtype`` are the run's: attention's internal traffic
    depends on whether the flash kernels run there."""
    nparts = 1
    for d in part_degrees:
        nparts *= d
    flops = op.flops() / max(1, nparts)
    if backward:
        flops *= 2.0
    peak = spec.vpu_flops if op.op_type in _VPU_OPS else spec.mxu_flops
    peak *= op.mxu_efficiency(spec)
    if precision == "f32" and op.op_type not in _VPU_OPS:
        peak *= spec.f32_matmul_scale
    run_dtype = PRECISION_DTYPES.get(precision, compute_dtype)
    dtype_bytes = precision_dtype_bytes(precision, dtype_bytes)
    io_bytes = 0
    for t in list(op.inputs) + list(op.outputs):
        io_bytes += t.volume * dtype_bytes
    io_bytes += sum(w.volume * 4 for w in op.weights)
    io_bytes += op.internal_io_bytes(flash_attention=flash_attention,
                                     device=device,
                                     compute_dtype=run_dtype)
    io_bytes /= max(1, nparts)
    if backward:
        io_bytes *= 2.0
    t = max(flops / peak, io_bytes / spec.hbm_bw)
    if backward:
        t *= op.backward_overhead(part_degrees, spec)
    return t + spec.kernel_launch


def transfer_time(nbytes: float, intra_slice: bool,
                  spec: DeviceSpec = DEFAULT_SPEC) -> float:
    """Point-to-point transfer cost: a hop inside a host (``ici_bw``) or
    between hosts (``dcn_bw``), plus ``ici_latency``."""
    if nbytes <= 0:
        return 0.0
    bw = spec.ici_bw if intra_slice else spec.dcn_bw
    return spec.ici_latency + nbytes / bw


def allreduce_time(nbytes: float, num_replicas: int,
                   spec: DeviceSpec = DEFAULT_SPEC,
                   members_per_slice: int = 0) -> float:
    """Ring-allreduce cost: 2*(k-1)/k * bytes / bw.
    ``members_per_slice`` — how many of the group's members share one
    host (0 = all of them).  A group spanning hosts runs the
    hierarchical form: reduce-scatter within each host, a ring between
    hosts over ``dcn_bw`` on the 1/k1 shard, then an all-gather within
    each host."""
    if num_replicas <= 1 or nbytes <= 0:
        return 0.0
    k1 = min(num_replicas, members_per_slice or num_replicas)
    k2 = -(-num_replicas // max(1, k1))  # hosts spanned
    t = 0.0
    if k1 > 1:
        t += (spec.ici_latency * (k1 - 1)
              + 2.0 * (k1 - 1) / k1 * nbytes / spec.ici_bw)
    if k2 > 1:
        t += (spec.ici_latency * (k2 - 1)
              + 2.0 * (k2 - 1) / k2 * (nbytes / max(1, k1)) / spec.dcn_bw)
    return t


# Ops whose outputs the model does not count as standalone buffers: pure
# layout views (reshape/transpose/flat/split) and unary epilogues
# (dropout's mask is redrawn from its generator, not stored).
# ELEMENT_BINARY stays RESIDENT: a residual add's output is the trunk
# activation every downstream consumer retains for backward.  The JAX
# package's model, kept as it is so both packages judge a strategy alike;
# the measured ``temp_factor`` absorbs what eager torch holds beyond it.
_UNMATERIALIZED_OPS = {
    OpType.RESHAPE, OpType.TRANSPOSE, OpType.FLAT, OpType.SPLIT,
    OpType.ELEMENT_UNARY, OpType.DROPOUT,
}


def op_memory_bytes(op: Op, part_degrees: Tuple[int, ...],
                    dtype_bytes: int = 2, opt_slot_bytes: int = 4,
                    axes: Tuple[str, ...] = (),
                    stack_degrees: Dict[str, int] | None = None,
                    remat: bool = False,
                    act_scale: float | None = None,
                    sparse_tables=frozenset()) -> float:
    """Per-device resident bytes one op contributes to the training
    step's high-water mark:

    * parameters + their gradients (f32) + optimizer slots, sharded over
      the ``c`` (channel/TP) degrees when the weight declares a
      ``sharded_dim``, replicated otherwise;
    * expert-/stage-stacked weights (``shard_axis`` 'e'/'p') shard over
      their dedicated mesh axis at the size given in ``stack_degrees``
      ({"e": ..., "p": ...}); absent/1 means REPLICATED — the
      conservative truth on meshes that do not raise those axes (the
      SOAP search's candidate meshes pin e=p=1);
    * the op's output activations (retained for backward), divided over
      ALL partition degrees — EXCEPT view/fused ops
      (``_UNMATERIALIZED_OPS``).  Under ``remat`` (sqrt(N)-segmented,
      ``FFModel._execute_remat``) the resident fraction is ``act_scale``:
      segment boundaries plus one recomputed segment interior, which the
      caller that knows the layer count sets to ``2/sqrt(N)``
      (``Simulator.peak_memory_bytes``); standalone calls fall back to
      0.5.

    Delegates to :func:`op_memory_components` — ONE accounting shared
    with the liveness timeline (``Simulator.memory_timeline``), so the
    FF108 scalar bound and the FF121 interval analysis cannot drift.
    """
    state, act = op_memory_components(
        op, part_degrees, dtype_bytes=dtype_bytes,
        opt_slot_bytes=opt_slot_bytes, axes=axes,
        stack_degrees=stack_degrees, remat=remat, act_scale=act_scale,
        sparse_tables=sparse_tables)
    return state + act


def op_memory_components(op: Op, part_degrees: Tuple[int, ...],
                         dtype_bytes: int = 2, opt_slot_bytes: int = 4,
                         axes: Tuple[str, ...] = (),
                         stack_degrees: Dict[str, int] | None = None,
                         remat: bool = False,
                         act_scale: float | None = None,
                         sparse_tables=frozenset()) -> Tuple[float, float]:
    """The two liveness classes of :func:`op_memory_bytes`, separated for
    the interval analysis (``Simulator.memory_timeline``):

    * ``state_bytes`` — params + grads + optimizer slots: resident for
      the WHOLE training step (live range = the full interval; donation
      means the updated copy replaces, never doubles, them);
    * ``act_bytes`` — the op's retained output activations: live from
      the op's forward event until its own backward event completes
      (in reverse topological order an op's backward is the last use of
      its stored activation — every consumer's backward ran earlier).

    Same accounting, same arguments, same sharding rules as
    :func:`op_memory_bytes` — that function remains the one-shot sum
    (``state + act``) the FF108 legality bound and the search's inf
    gate are pinned to."""
    stack_degrees = stack_degrees or {}
    if act_scale is None:
        act_scale = 0.5 if remat else 1.0
    c_deg = 1
    for deg, ax in zip(part_degrees, axes):
        if ax == "c":
            c_deg *= deg
    nparts = 1
    for d in part_degrees:
        nparts *= d
    state = 0.0
    for w in op.weights:
        if w.name in sparse_tables:
            # sparse-update table (FFModel._sparse_embedding_specs): no
            # table-shaped gradient ever materializes (row grads are
            # activation-sized) and plain SGD — the eligibility
            # condition — keeps no slots; only the params reside
            per_param = w.volume * 4.0
        else:
            per_param = w.volume * (4.0 * 2 + opt_slot_bytes)  # +grad+slots
        stack_ax = getattr(w, "shard_axis", "c")
        if stack_ax in ("e", "p") and w.sharded_dim is not None:
            deg = stack_degrees.get(stack_ax, 1)
            per_param /= max(1, min(w.shape[w.sharded_dim], deg))
        elif (w.sharded_dim is not None and c_deg > 1
                and w.shape[w.sharded_dim] % c_deg == 0):
            per_param /= c_deg
        state += per_param
    act = 0.0
    if op.op_type not in _UNMATERIALIZED_OPS:
        for t in op.outputs:
            act += act_scale * t.volume * dtype_bytes / max(1, nparts)
    return state, act
