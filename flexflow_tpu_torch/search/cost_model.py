"""The memory half of the JAX package's analytic cost model
(``search/cost_model.py``), with the port's device: one NVIDIA H100 SXM.

:func:`op_memory_bytes` / :func:`op_memory_components` account one op's
per-device resident bytes under a strategy; the simulator sums them into
a step's high-water mark, and the verifier holds it, times
:data:`TEMP_FACTOR`, against :attr:`DeviceSpec.hbm_capacity` (FF108).
The time half (op compute time, transfers, allreduces) comes with the
strategy search.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..op import Op, OpType


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Per-device capability model.  The field names are the JAX
    package's: ``mxu_flops`` is the matrix (tensor-core) rate,
    ``vpu_flops`` the elementwise rate, ``ici_bw`` the device-to-device
    link.  The latency and between-host fields come with the time half
    of the cost model."""

    mxu_flops: float
    vpu_flops: float
    hbm_bw: float
    hbm_capacity: float
    ici_bw: float


# NVIDIA H100 SXM5 80GB, NVIDIA's H100 Tensor Core GPU data sheet (dense
# rates, without sparsity, at the 700 W limit): 989 TFLOP/s bf16 tensor
# core, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM3,
# 80 GB, NVLink 900 GB/s.
H100_SXM_SPEC = DeviceSpec(mxu_flops=989e12, vpu_flops=67e12,
                           hbm_bw=3.35e12, hbm_capacity=80e9,
                           ici_bw=900e9)

_KIND_TO_SPEC = {
    "NVIDIA H100 80GB HBM3": H100_SXM_SPEC,
}

DEFAULT_SPEC = H100_SXM_SPEC

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
    precision→bytes rule of the FF108/FF121 memory accounting."""
    if precision == "bf16":
        return 2
    if precision == "f32":
        return 4
    return default


# Ops whose outputs the model does not count as standalone buffers: pure
# layout views (reshape/transpose/flat/split) and unary epilogues
# (dropout's mask is redrawn from its generator, not stored).
# ELEMENT_BINARY stays RESIDENT: a residual add's output is the trunk
# activation every downstream consumer retains for backward.  The JAX
# package's model, kept as it is so both packages judge a strategy alike;
# the measured TEMP_FACTOR absorbs what eager torch holds beyond it.
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
