"""Op — abstract operator base, the counterpart of ``flexflow_tpu/op.py``.

``forward(params, inputs, ctx)`` keeps the JAX package's signature: a
function of the parameter dict and the input tensors that returns the
output tensors.  The port runs it eagerly on ``ctx.device``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .config import ParallelConfig
from .tensor import Parameter, Tensor


class OpType(enum.Enum):
    CONV2D = "conv2d"
    POOL2D = "pool2d"
    LINEAR = "linear"
    EMBEDDING = "embedding"
    FLAT = "flat"
    SOFTMAX = "softmax"
    CONCAT = "concat"
    SPLIT = "split"
    RESHAPE = "reshape"
    TRANSPOSE = "transpose"
    DROPOUT = "dropout"
    BATCHNORM = "batchnorm"
    LAYERNORM = "layernorm"
    RMSNORM = "rmsnorm"
    ELEMENT_UNARY = "element_unary"
    ELEMENT_BINARY = "element_binary"
    MSELOSS = "mse_loss"
    ATTENTION = "attention"
    LSTM = "lstm"
    PIPELINE = "pipeline"
    MOE = "moe"
    INPUT = "input"


def resolve_conv_layout(value: str, device: torch.device) -> str:
    """Normalize and validate a conv_layout setting; a typo fails.

    ``auto`` resolves to ``nhwc`` on a CUDA device — the max-pool
    kernel reads channels-last, so a channels-last conv trunk pays no
    conversion between conv and pool — and to ``nchw`` elsewhere, as
    the JAX package stays NCHW off the TPU."""
    v = (value or "auto").lower()
    if v not in ("nchw", "nhwc", "auto"):
        raise ValueError(
            f"conv_layout must be 'nchw', 'nhwc' or 'auto', got {value!r}")
    if v != "auto":
        return v
    return "nhwc" if torch.device(device).type == "cuda" else "nchw"


@dataclasses.dataclass
class OpContext:
    """Per-forward execution context threaded through op forwards."""

    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    # the training step's random seed (from config.seed and the step);
    # None outside training, where no op draws random numbers
    seed: Optional[int] = None
    training: bool = False
    compute_dtype: str = "bfloat16"
    # "nchw" or "nhwc" (torch.channels_last).  Tensor metadata stays
    # NCHW either way; ops convert memory format at their own boundary
    conv_layout: str = "nchw"
    # FFConfig.flash_attention: False keeps attention off the flash
    # kernels (ops/attention.py states the selection rule)
    flash_attention: Optional[bool] = None
    # non-trainable state an op hands back in training: {parameter name:
    # new value} (BatchNorm's running statistics); the train step applies
    # them after the optimizer's update.  Empty outside training
    updates: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # the sparse embedding update's rows: {Embedding op name: rows
    # gathered by the train step}, leaves that autograd differentiates
    # with respect to in place of the table (FFModel._sparse_specs)
    embedding_rows: Optional[Dict[str, torch.Tensor]] = None
    # auxiliary objectives an op adds in training: {op name: 0-d loss}
    # (MoE's load-balance loss); the train step adds their sum to the
    # loss, as the JAX step does
    aux_losses: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # the MachineMesh of a run on a mesh (values are DTensors there),
    # else None; ``out_placements`` maps the uid of each output of an op
    # with a strategy to the placements it is redistributed to
    mesh: Optional[object] = None
    out_placements: Dict[int, list] = dataclasses.field(
        default_factory=dict)
    # ops run on one rank's local tensors inside a pipeline stage: the
    # lines (``parallel.distributed.AxisGroup``) their values are split
    # over, {"n": the batch's line or None, "e": the experts' or None}
    groups: Optional[Dict[str, object]] = None

    def op_generator(self, uid: int) -> Optional[torch.Generator]:
        """The random stream of the op whose output has ``uid`` in this
        step: a generator on the context's device seeded from the step's
        seed and ``uid`` (the JAX ops fold the output uid into the
        step's key the same way).  None when the step has no seed."""
        if self.seed is None:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1_000_003 + int(uid))
                        & 0x7FFF_FFFF_FFFF_FFFF)
        return gen


def pad_degrees(part_degrees, rank: int):
    """Output partition degrees padded with 1s or truncated to ``rank``
    dims."""
    return tuple(part_degrees[:rank]) + \
        (1,) * max(0, rank - len(part_degrees))


def snap_degrees(dims, shape):
    """Degree 1 (replicated) for any dim a degree does not divide."""
    return tuple(d if d <= s and s % max(1, d) == 0 else 1
                 for d, s in zip(dims, shape))


def fold_seed(seed: int, i: int) -> int:
    """The seed of part ``i`` of a step whose seed is ``seed`` (the
    microbatches of an accumulated step), as the JAX step folds ``i``
    into its key with ``jax.random.fold_in``: a fixed function of both,
    so a part redraws the same random numbers whenever it reruns."""
    return (seed * 0x5851F42D4C957F2D + int(i) + 1) & 0x7FFF_FFFF_FFFF_FFFF


class Op:
    """Base operator.  Subclasses set ``op_type`` and implement
    ``forward``."""

    op_type: OpType = OpType.INPUT
    # the mesh axes whose lines this op's forward runs collectives over
    # on its own (``FFModel.compile`` makes their process groups); an op
    # with ``"p"`` among them talks to other ranks inside its forward and
    # is never recomputed by rematerialisation
    collective_axes: Tuple[str, ...] = ()

    def __init__(self, name: str, inputs: Sequence[Tensor]):
        self.name = name
        self.inputs: List[Tensor] = list(inputs)
        self.outputs: List[Tensor] = []
        self.weights: List[Parameter] = []
        self.parallel_config: Optional[ParallelConfig] = None

    def _add_output(self, shape, dtype="float32", idx: int = 0) -> Tensor:
        t = Tensor(shape=tuple(int(s) for s in shape), dtype=dtype,
                   name=f"{self.name}:out{idx}", owner_op=self,
                   owner_idx=idx)
        self.outputs.append(t)
        return t

    def _add_weight(self, shape, initializer, name: str, dtype="float32",
                    sharded_dim: Optional[int] = None,
                    trainable: bool = True) -> Parameter:
        p = Parameter(shape=tuple(int(s) for s in shape), dtype=dtype,
                      name=f"{self.name}/{name}", pcname=self.name,
                      initializer=initializer, sharded_dim=sharded_dim,
                      trainable=trainable)
        self.weights.append(p)
        return p

    def parallel_dims(self) -> Tuple[bool, ...]:
        """Which output dims a strategy may partition.  Default: the
        sample dim only."""
        nd = self.outputs[0].num_dims if self.outputs else 1
        return (True,) + (False,) * (nd - 1)

    def forward(self, params: Dict[str, torch.Tensor],
                inputs: List[torch.Tensor],
                ctx: OpContext) -> List[torch.Tensor]:
        raise NotImplementedError

    # --- the cost model's inputs (search/cost_model.py) ---------------
    def flops(self) -> int:
        """Forward FLOPs for the whole (unpartitioned) op."""
        return 2 * self.outputs[0].volume if self.outputs else 0

    def mxu_efficiency(self, spec=None) -> float:
        """Fraction of the matrix rate this op's contraction reaches on
        the device ``spec`` describes (a ``search.cost_model.DeviceSpec``;
        its correction fields hold what a device measured).  Default
        1.0."""
        return 1.0

    def backward_overhead(self, part_degrees=None, spec=None) -> float:
        """Multiplier on the backward roofline for ops whose backward on
        the device ``spec`` describes exceeds the 2x-forward model
        (default 1.0).  ``part_degrees`` is the split under evaluation.
        An analytic-mode correction only: measure mode times the real
        kernels."""
        return 1.0

    def internal_io_bytes(self, flash_attention=None, device="cuda",
                          compute_dtype: str = "bfloat16") -> int:
        """Device-memory traffic of intermediates that are neither op
        inputs nor outputs (default none).  ``flash_attention``,
        ``device`` and ``compute_dtype`` are the run's, so an op whose
        internals depend on the kernel that runs (attention) charges
        that kernel's."""
        return 0

    def kernel_libraries(self, config) -> Tuple[str, ...]:
        """The hand-written kernel libraries (``csrc/<name>.cu``) this
        op's training step launches on a CUDA device under ``config``
        (default none); ``FFModel.warmup_compile`` loads them."""
        return ()

    def weight_bytes(self) -> int:
        return sum(w.volume * 4 for w in self.weights)

    def sub_problem(self, part_degrees):
        """Per-partition ``(input_shapes, weight_shapes)`` for timing ONE
        shard of this op alone (measure mode).  Default: the output's
        degrees projected dim by dim onto each input, degree 1 where a
        degree does not divide (the simulator's own fallback); weights
        full-size.  Ops whose channel split shards a weight override.
        Raises ValueError for degrees that cannot be realised (the
        simulator scores those inf)."""
        in_shapes = []
        for t in self.inputs:
            dims = snap_degrees(pad_degrees(part_degrees, t.num_dims),
                                t.shape)
            in_shapes.append(t.sub_shape(dims))
        return in_shapes, {w.name: w.shape for w in self.weights}

    def activation_bytes(self) -> int:
        return sum(t.volume * 4 for t in self.outputs)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"
