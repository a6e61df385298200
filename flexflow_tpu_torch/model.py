"""FFModel — graph builder, single-device compile, training and
inference verbs, and checkpoints.

Counterpart of ``flexflow_tpu/model.py`` on one device: the builder
methods append Ops to a layer list with the JAX package's naming (so
parameter names match one for one), ``compile()`` resolves the
single-device plan, ``init_layers`` creates the parameters and the
optimizer state on the model's device, ``train_batch``/``train_window``/
``fit``/``evaluate`` train and evaluate eagerly with autograd (on CUDA
the max pools' and the flash attention's gradients come from their
hand-written backward kernels; plain SGD updates eligible embedding
tables row by row, ``_sparse_embedding_specs``), and
``forward_compiled``/``predict`` run the forward under
``torch.inference_mode()``.

The training loop takes the JAX package's knobs: gradient accumulation
(k equal microbatches, one optimizer update), multi-step windows
(``steps_per_dispatch``: K steps staged and run back to back, in eager
torch the steps of K=1),
padded tail batches (the masked step over the valid rows) and segmented
rematerialisation (``torch.utils.checkpoint`` over ~sqrt(N) segments of
the layer list).  ``save_checkpoint``/``load_checkpoint`` read and write
the JAX package's ``.npz`` format, so either package resumes from the
other's file.

``compile`` resolves a parallelization strategy (``FFConfig.strategies``
and ``import_strategy_file``; ``export_strategy_file`` writes it) and runs
the static verifier over it (``verify=``).  A per-op ``precision`` sets
that op's compute dtype, and a host-placed op keeps its parameters in
pinned host memory: an Embedding gathers there, any other op copies its
parameters to the device for its forward, and the update runs on the
device, the values going back to their pinned buffers.

Under a :class:`~flexflow_tpu_torch.parallel.mesh.MachineMesh` (one
process per device, ``parallel/distributed.py``) the degrees of the axes
``n``, ``c``, ``h``, ``w`` and ``s`` shard the run, GSPMD mapped onto
DTensor: each parameter is a DTensor placed by its ``param_spec``, each
input batch by its ``batch_spec``, and each output of an op with a
strategy is redistributed to its ``output_spec`` (the JAX package's
``with_sharding_constraint``).  The hand-written kernels run on each
rank's local shard (``parallel.sharding.shard_map``), ring attention
runs over ``s``, pipeline stages over ``p`` (``ops/pipeline.py``) and a
MoE's experts over ``e``, the loss and metrics reduce over the global
batch, and ``predict``/``evaluate``/``get_weights`` return full arrays
on every rank.  Every rank feeds the same full arrays, the JAX
package's multi-controller contract.  ``reshard`` moves live state onto
another factorization of the same world in process; another device
count goes through the supervisor (``parallel/elastic.py``).
``search_budget > 0`` searches the strategy (``search/mcmc.py``: the
SOAP space on the simulator, analytic or measured on the device) for the
process group's devices, unless a strategy file is imported.

The model runs on CUDA unless the caller passes another device
(``device="cpu"`` in the tests); without CUDA and without a device it
raises instead of falling back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
import traceback
from time import perf_counter as _perf_counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from . import faults, losses
from . import metrics as metrics_mod
from .config import FFConfig
from .data.dataloader import PrefetchLoader, upload
from .initializers import GlorotUniform
from .op import Op, OpContext, OpType, fold_seed, resolve_conv_layout
from .ops.common import resolve_op_dtype, torch_dtype
from .ops.attention import MultiHeadAttention, PositionEmbedding
from .ops.conv import Conv2D, Pool2D
from .ops.elementwise import ElementBinary, ElementUnary
from .ops.linear import (Embedding, Linear, host_gather, host_placed,
                         map_ids, take_rows)
from .ops.loss_ops import MSELoss
from .ops.moe import MoE
from .ops.norm import BatchNorm, LayerNorm, RMSNorm
from .ops.pipeline import PipelineSegment, PipelineTransformerBlock
from .ops.rnn import LSTM
from .ops.tensor_ops import (Concat, Dropout, Flat, Reshape, Softmax, Split,
                             Transpose)
from .optimizers import SGDOptimizer
from .parallel import distributed
from .parallel.mesh import (AbstractMesh, MachineMesh, dim_axis_names,
                            scaled_shape)
from .parallel.sharding import (batch_spec, distribute, gather, is_dtensor,
                                keep_shards, output_spec, param_spec,
                                redistribute)
from .resilience import (MANIFEST_KEY, _atomic_savez, _cleanup_stale_tmps,
                         _prune_step_family, build_manifest,
                         read_npz_verified)
from .tensor import Parameter, Tensor


def default_device() -> torch.device:
    """The device entry points run on when the caller names none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flexflow_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return torch.device("cuda")


def to_host(t: torch.Tensor) -> np.ndarray:
    """Fetch a tensor to numpy; bfloat16 (which numpy cannot hold)
    comes back as its exact float32 upcast."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


def _flatten_state(state) -> list:
    """The optimizer state's leaves in ``jax.tree_util`` flatten order
    (dict keys sorted at every level), the order of a checkpoint's
    ``opt:<i>`` arrays: Adam is ``m/<names>, t, v/<names>``."""
    if isinstance(state, dict):
        return [leaf for k in sorted(state) for leaf in
                _flatten_state(state[k])]
    return [state]


def _unflatten_state(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        return {k: _unflatten_state(template[k], leaves)
                for k in sorted(template)}
    return next(leaves)


def _leaf_shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def _leaf_to_host(leaf) -> np.ndarray:
    """An optimizer-state leaf as an owned numpy array (Adam's step
    count, a Python int, as the JAX package's int32 scalar)."""
    if isinstance(leaf, torch.Tensor):
        return np.array(to_host(gather(leaf)))
    return np.asarray(leaf, np.int32)


def _mesh_context(on_mesh: bool):
    """Where the model runs on a mesh, plain tensors (masks, constants)
    meet DTensors as replicated values: every rank holds the same full
    value, so they are."""
    if not on_mesh:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None,
                 device=None, mesh: Optional[MachineMesh] = None):
        self.config = config if config is not None else FFConfig()
        if device is None and mesh is not None:
            device = mesh.device
        self.device = (default_device() if device is None
                       else torch.device(device))
        self.layers: List[Op] = []
        self.parameters: List[Parameter] = []
        self.input_tensors: List[Tensor] = []
        self.label_tensor: Optional[Tensor] = None
        self.optimizer = None
        self.loss_type: Optional[str] = None
        self.metrics: List[str] = []
        self._name_counts: Dict[str, int] = {}
        self._compiled = False
        self._params: Dict[str, torch.Tensor] = {}
        self._fwd_compiled: Dict[int, Callable] = {}
        self._sparse_specs: List[tuple] = []
        # host-placed parameters: their names, those of ops that run on
        # the device (copied there for the forward), and the tables that
        # take the row update on the host (_host_row_specs)
        self._host_params: set = set()
        self._host_stream: List[str] = []
        self._host_rows: List[tuple] = []
        self.mesh = mesh
        # on a MachineMesh with a DeviceMesh: the DTensor placements of
        # every parameter and of every output of an op with a strategy
        self._on_mesh = False
        self._param_pl: Dict[str, list] = {}
        self._out_pl: Dict[int, list] = {}
        # the replicate-fallback sites drained after dispatches (FF106)
        self.runtime_fallback_sites: set = set()
        self.verify_report = None
        self._opt_state = None
        self._step = 0
        self._batch: Optional[tuple] = None
        self._cached_grads: Optional[Dict[str, torch.Tensor]] = None
        self._ckpt_writer: Optional[threading.Thread] = None
        self._ckpt_exc: Optional[BaseException] = None
        self.perf_metrics = metrics_mod.PerfMetrics()
        self.last_epoch_losses = np.zeros((0,), np.float32)
        # int8 weight-only serving (quantize_weights): the mode and the
        # quality report; one-way for this instance
        self._quantized: str = ""
        self._quant_report: Optional[Dict] = None

    # ------------------------------------------------------------------
    # graph construction
    # ------------------------------------------------------------------
    def _uname(self, prefix: str, name: Optional[str]) -> str:
        if name:
            return name
        k = self._name_counts.get(prefix, 0)
        self._name_counts[prefix] = k + 1
        return f"{prefix}_{k}" if k else prefix

    def _register(self, op: Op) -> Op:
        self.layers.append(op)
        self.parameters.extend(op.weights)
        return op

    def create_tensor(self, shape: Sequence[int], dtype: str = "float32",
                      name: str = "input") -> Tensor:
        t = Tensor(shape=tuple(int(s) for s in shape), dtype=dtype,
                   name=name)
        self.input_tensors.append(t)
        return t

    create_input = create_tensor

    def conv2d(self, input_tensor, out_channels, kernel_h, kernel_w,
               stride_h, stride_w, padding_h, padding_w, activation=None,
               groups=1, use_bias=True, kernel_initializer=None,
               bias_initializer=None, name=None) -> Tensor:
        op = Conv2D(self._uname("conv2d", name), input_tensor, out_channels,
                    kernel_h, kernel_w, stride_h, stride_w, padding_h,
                    padding_w, activation, use_bias, groups,
                    kernel_initializer, bias_initializer)
        return self._register(op).outputs[0]

    def pool2d(self, input_tensor, kernel_h, kernel_w, stride_h, stride_w,
               padding_h, padding_w, pool_type="max", activation=None,
               name=None) -> Tensor:
        op = Pool2D(self._uname("pool2d", name), input_tensor, kernel_h,
                    kernel_w, stride_h, stride_w, padding_h, padding_w,
                    pool_type, activation)
        return self._register(op).outputs[0]

    def dense(self, input_tensor, out_dim, activation=None, use_bias=True,
              kernel_initializer=None, bias_initializer=None,
              name=None) -> Tensor:
        op = Linear(self._uname("dense", name), input_tensor, out_dim,
                    activation, use_bias, kernel_initializer,
                    bias_initializer)
        return self._register(op).outputs[0]

    linear = dense

    def flat(self, input_tensor, name=None) -> Tensor:
        return self._register(
            Flat(self._uname("flat", name), input_tensor)).outputs[0]

    def softmax(self, input_tensor, axis=-1, name=None) -> Tensor:
        return self._register(
            Softmax(self._uname("softmax", name), input_tensor,
                    axis)).outputs[0]

    def embedding(self, input_tensor, num_entries, out_dim, aggr="sum",
                  kernel_initializer=None, name=None) -> Tensor:
        op = Embedding(self._uname("embedding", name), input_tensor,
                       num_entries, out_dim, aggr, kernel_initializer)
        return self._register(op).outputs[0]

    def lstm(self, input_tensor, hidden_size, initial_state=None,
             forget_bias=1.0, kernel_initializer=None, name=None):
        """Single-layer LSTM.  Returns ``(seq, h_n, c_n)``; pass
        ``initial_state=(h, c)`` to chain encoder and decoder."""
        op = LSTM(self._uname("lstm", name), input_tensor, hidden_size,
                  initial_state, forget_bias, kernel_initializer)
        self._register(op)
        return op.outputs[0], op.outputs[1], op.outputs[2]

    def multihead_attention(self, query, key=None, value=None, embed_dim=None,
                            num_heads=8, kdim=0, vdim=0, dropout=0.0,
                            bias=True, causal=False, kernel_initializer=None,
                            name=None) -> Tensor:
        key = key if key is not None else query
        value = value if value is not None else key
        embed_dim = embed_dim or query.shape[-1]
        op = MultiHeadAttention(self._uname("attention", name), query, key,
                                value, embed_dim, num_heads, kdim, vdim,
                                dropout, bias, causal, kernel_initializer)
        return self._register(op).outputs[0]

    def position_embedding(self, input_tensor, max_len=None,
                           kernel_initializer=None, name=None) -> Tensor:
        op = PositionEmbedding(self._uname("pos_embedding", name),
                               input_tensor, max_len, kernel_initializer)
        return self._register(op).outputs[0]

    def concat(self, tensors, axis, name=None) -> Tensor:
        return self._register(
            Concat(self._uname("concat", name), tensors, axis)).outputs[0]

    def split(self, input_tensor, sizes, axis, name=None) -> List[Tensor]:
        if isinstance(sizes, int):
            total = input_tensor.shape[axis]
            sizes = [total // sizes] * sizes
        return self._register(
            Split(self._uname("split", name), input_tensor, sizes,
                  axis)).outputs

    def reshape(self, input_tensor, shape, name=None) -> Tensor:
        return self._register(
            Reshape(self._uname("reshape", name), input_tensor,
                    shape)).outputs[0]

    def transpose(self, input_tensor, perm, name=None) -> Tensor:
        return self._register(
            Transpose(self._uname("transpose", name), input_tensor,
                      perm)).outputs[0]

    def dropout(self, input_tensor, rate, seed=0, name=None) -> Tensor:
        return self._register(
            Dropout(self._uname("dropout", name), input_tensor, rate,
                    seed)).outputs[0]

    def batch_norm(self, input_tensor, relu=True, momentum=0.9, eps=1e-5,
                   name=None) -> Tensor:
        return self._register(
            BatchNorm(self._uname("batchnorm", name), input_tensor, relu,
                      momentum, eps)).outputs[0]

    def layer_norm(self, input_tensor, eps=1e-5, name=None) -> Tensor:
        return self._register(
            LayerNorm(self._uname("layernorm", name), input_tensor,
                      eps)).outputs[0]

    def rms_norm(self, input_tensor, eps=1e-6, name=None) -> Tensor:
        return self._register(
            RMSNorm(self._uname("rmsnorm", name), input_tensor,
                    eps)).outputs[0]

    def moe(self, input_tensor, num_experts, d_ff, k=2, capacity_factor=1.25,
            activation="gelu", aux_loss_weight=1e-2, kernel_initializer=None,
            name=None) -> Tensor:
        """Mixture-of-Experts FFN with top-k routing and capacity-factor
        dispatch, its experts split over the 'e' mesh axis
        (``ops/moe.py``); its load-balance loss joins the training
        objective."""
        op = MoE(self._uname("moe", name), input_tensor, num_experts, d_ff,
                 k, capacity_factor, activation, aux_loss_weight,
                 kernel_initializer)
        return self._register(op).outputs[0]

    def pipeline_transformer_block(self, input_tensor, num_stages, num_heads,
                                   d_ff, num_microbatches=None,
                                   schedule="gpipe", virtual_stages=None,
                                   name=None) -> Tensor:
        """A stack of identical encoder blocks run as a pipeline over the
        'p' mesh axis (``ops/pipeline.py``).  ``schedule``: "gpipe" or
        "interleaved" (requires ``virtual_stages`` chunks per rank)."""
        op = PipelineTransformerBlock(
            self._uname("pipeline_block", name), input_tensor, num_stages,
            num_heads, d_ff, num_microbatches, schedule=schedule,
            virtual_stages=virtual_stages)
        return self._register(op).outputs[0]

    def pipeline(self, input_tensor, num_stages, stage_builder,
                 num_microbatches=None, schedule="gpipe",
                 virtual_stages=None, name=None) -> Tensor:
        """Pipeline ``num_stages`` instances of any FFModel subgraph over
        the 'p' mesh axis.  ``stage_builder(seg, t)`` builds one stage
        against a fresh model ``seg`` and a probe tensor ``t`` (same
        shape in and out); the subgraph may hold dense layers and
        ``moe``, whose experts split over 'e' inside the stage."""
        op = PipelineSegment(self._uname("pipeline", name), input_tensor,
                             num_stages, stage_builder, self.config,
                             num_microbatches, schedule=schedule,
                             virtual_stages=virtual_stages,
                             device=self.device)
        return self._register(op).outputs[0]

    # element unary builders (reference model.h: exp/relu/... adders)
    def _unary(self, fn, x, name=None, scalar=None) -> Tensor:
        return self._register(
            ElementUnary(self._uname(fn, name), x, fn, scalar)).outputs[0]

    def exp(self, x, name=None):
        return self._unary("exp", x, name)

    def relu(self, x, name=None):
        return self._unary("relu", x, name)

    def sigmoid(self, x, name=None):
        return self._unary("sigmoid", x, name)

    def tanh(self, x, name=None):
        return self._unary("tanh", x, name)

    def elu(self, x, name=None):
        return self._unary("elu", x, name)

    def gelu(self, x, name=None):
        return self._unary("gelu", x, name)

    def identity(self, x, name=None):
        return self._unary("identity", x, name)

    def scalar_multiply(self, x, scalar, name=None):
        return self._unary("scalar_mul", x, name, scalar)

    def _binary(self, fn, a, b, name=None) -> Tensor:
        return self._register(
            ElementBinary(self._uname(fn, name), a, b, fn)).outputs[0]

    def add(self, a, b, name=None):
        return self._binary("add", a, b, name)

    def subtract(self, a, b, name=None):
        return self._binary("sub", a, b, name)

    def multiply(self, a, b, name=None):
        return self._binary("mul", a, b, name)

    def divide(self, a, b, name=None):
        return self._binary("div", a, b, name)

    def mse_loss(self, logits: Tensor, labels_shape=None,
                 reduction="average", name=None) -> Tensor:
        """The op-form MSE loss (DLRM, CANDLE-Uno): an identity op that
        sets the model's loss type and adds the mse metric, which
        ``compile(metrics=[])`` then falls back to."""
        op = MSELoss(self._uname("mse_loss", name), logits, reduction)
        self._register(op)
        self.loss_type = (losses.MEAN_SQUARED_ERROR_AVG_REDUCE
                          if reduction == "average"
                          else losses.MEAN_SQUARED_ERROR_SUM_REDUCE)
        if losses.MEAN_SQUARED_ERROR not in self.metrics:
            self.metrics.append(losses.MEAN_SQUARED_ERROR)
        return op.outputs[0]

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def compile(self, optimizer=None, loss_type: Optional[str] = None,
                metrics: Optional[Sequence[str]] = None,
                comp_mode: str = "training", mesh=None,
                final_tensor: Optional[Tensor] = None,
                verify: str = "warn") -> None:
        """Resolve the plan: loss tensor, label tensor, conv layout,
        optimizer (default: SGD from the config's learning rate and
        weight decay), metrics, the strategy, the mesh and the embedding
        tables' update paths.

        The mesh is ``mesh`` (or the one given to the constructor), else,
        where a process group is up, a :class:`MachineMesh` of
        ``config.mesh_shape`` or of the shape the strategies need over
        every rank, else one device.

        The strategy is ``config.strategies`` updated from
        ``import_strategy_file``; each op takes the entry of its name as
        its ``parallel_config``, and ``export_strategy_file`` gets the
        resolved entries.  ``verify`` runs the static verifier
        (``analysis.verify_compile``) before anything runs: ``"warn"``
        (default) warns once with the ERROR and WARN diagnostics,
        ``"error"`` raises ``analysis.VerificationError`` on an ERROR,
        ``"off"`` skips it; the report is kept on ``verify_report``.

        Raises ValueError for a strategy that needs more devices than
        the mesh has, for ``gradient_accumulation_steps`` or
        ``steps_per_dispatch`` below 1, for a batch size that does not
        divide into the microbatches and for a calibration setting that
        does not resolve (a ``calibration_file`` that does not load, an
        unknown ``cost_estimator`` or one that needs a table), and
        NotImplementedError for what the port cannot run yet (a
        multi-device mesh in a process without a process group, a trace
        directory), each naming the roadmap item that lifts it.

        ``search_budget > 0`` (and no ``import_strategy_file``) runs the
        strategy search first (``search.mcmc.optimize_strategies``, as
        the JAX package's compile does) for the process group's devices
        (or ``config.num_devices``), on the model's device, and pins
        ``config.mesh_shape`` to the searched mesh when it is unset; the
        search's objective is calibrated by ``calibration_file`` and
        ``cost_estimator`` when they are set."""
        cfg = self.config
        if mesh is not None:
            if not isinstance(mesh, MachineMesh):
                raise TypeError(f"mesh must be a MachineMesh, got "
                                f"{type(mesh).__name__}")
            self.mesh = mesh
        elif not isinstance(self.mesh, MachineMesh):
            self.mesh = None   # an earlier compile's inferred mesh
        if self.mesh is None and distributed.world_size() == 1:
            n_dev = math.prod(int(v) for v in
                              (cfg.mesh_shape or {}).values())
            if cfg.num_devices > 1 or n_dev > 1:
                raise NotImplementedError(
                    "a mesh of more than one device needs one process "
                    "per device and their process group (ROADMAP A.8a: "
                    "parallel.distributed.initialize_distributed, then "
                    "compile(mesh=MachineMesh(...))); this process runs "
                    "one device")
        if cfg.trace_dir:
            raise NotImplementedError(
                "not ported yet (ROADMAP A.11): trace_dir")
        from .search.calibration import estimator_from_config
        estimator_from_config(cfg)   # a bad calibration setting fails here
        if cfg.gradient_accumulation_steps < 1:
            raise ValueError(
                f"gradient_accumulation_steps must be >= 1, got "
                f"{cfg.gradient_accumulation_steps}")
        if cfg.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got "
                f"{cfg.steps_per_dispatch}")
        self._check_accum_divisible(cfg.batch_size, "batch_size")
        if verify not in ("warn", "error", "off"):
            raise ValueError(
                f"verify must be 'warn', 'error' or 'off', got {verify!r}")
        if not self.layers:
            raise ValueError("compile() needs at least one layer")
        self.optimizer = optimizer or self.optimizer or SGDOptimizer(
            lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
        if loss_type is not None:
            self.loss_type = loss_type
        if self.loss_type is None:
            self.loss_type = losses.SPARSE_CATEGORICAL_CROSSENTROPY
        self._loss_fn = losses.get_loss_fn(self.loss_type)
        self._per_example_loss, self._loss_reduction = \
            losses.get_per_example_loss_fn(self.loss_type)
        self.metrics = metrics_mod.canonicalize_metrics(
            list(metrics or self.metrics or []))
        self.comp_mode = comp_mode
        self._final_tensor = final_tensor or self.layers[-1].outputs[0]
        # sparse-CCE is the fused logit form: when the graph ends in an
        # explicit Softmax the loss reads the Softmax INPUT, predictions
        # keep the softmax output
        self._loss_tensor = self._final_tensor
        owner = self._final_tensor.owner_op
        if (losses.uses_logits(self.loss_type) and owner is not None
                and owner.op_type == OpType.SOFTMAX):
            self._loss_tensor = owner.inputs[0]

        if cfg.import_strategy_file:
            from .strategy.proto import load_strategy_file
            cfg.strategies.update(
                load_strategy_file(cfg.import_strategy_file))
        elif cfg.search_budget > 0:
            from .search.mcmc import optimize_strategies
            cfg.strategies.update(optimize_strategies(self, cfg))
        for op in self.layers:
            op.parallel_config = cfg.strategies.get(op.name)
        if self.mesh is None:
            world = distributed.world_size()
            shape = (cfg.mesh_shape if cfg.mesh_shape is not None
                     else self._infer_mesh_shape(world))
            self.mesh = (MachineMesh(shape, device=self.device)
                         if distributed.world_size() > 1
                         else AbstractMesh(shape, num_devices=1))
        self._bind_mesh()
        if cfg.export_strategy_file:
            from .strategy.proto import save_strategy_file
            save_strategy_file(cfg.export_strategy_file,
                               {op.name: op.parallel_config
                                for op in self.layers if op.parallel_config})

        if self.label_tensor is None:
            n = self._final_tensor.shape[0]
            if self.loss_type == losses.SPARSE_CATEGORICAL_CROSSENTROPY:
                if self._final_tensor.num_dims == 3:
                    self.label_tensor = Tensor(
                        (n, self._final_tensor.shape[1]), "int32", "label")
                else:
                    self.label_tensor = Tensor((n, 1), "int32", "label")
            else:
                self.label_tensor = Tensor(self._final_tensor.shape,
                                           "float32", "label")
        self.resolved_conv_layout = resolve_conv_layout(cfg.conv_layout,
                                                        self.device)
        self._host_params = self._resolve_host_placements()
        self._sparse_specs = self._sparse_embedding_specs()
        self._host_rows = self._host_row_specs()
        self._run_verifier(verify)
        self._fwd_compiled = {}
        self._compiled = True

    def _infer_mesh_shape(self, ndev: int = 1) -> Dict[str, int]:
        """The mesh the resolved strategies need on ``ndev`` devices, as
        the JAX package infers it: each canonical axis sized to the LCM
        of the degrees ops assign to it, or to the largest degree when
        the LCM overshoots the devices; a strategy that needs more
        raises."""
        lcm = {"n": 1, "c": 1, "h": 1, "w": 1, "s": 1}
        mx = dict(lcm)
        any_cfg = False
        for op in self.layers:
            pc = op.parallel_config
            if pc is None:
                continue
            any_cfg = True
            for deg, ax in zip(pc.dims, dim_axis_names(len(pc.dims))):
                if ax and deg > 1:
                    lcm[ax] = math.lcm(lcm[ax], deg)
                    mx[ax] = max(mx[ax], deg)
        if not any_cfg:
            return {"n": ndev}
        if math.prod(lcm.values()) <= ndev:
            return lcm
        used = math.prod(mx.values())
        if used > ndev:
            raise ValueError(f"strategy needs {used} devices, have {ndev}")
        return mx

    def _bind_mesh(self) -> None:
        """Check the mesh against what the port runs on one and resolve
        the DTensor placements of the parameters and of the outputs of
        the ops with a strategy.  The specs are computed here once, so
        their replicate fallbacks are recorded once (FF106, drained after
        the first dispatch), as the JAX package records them at trace
        time."""
        mesh = self.mesh
        self._on_mesh = (isinstance(mesh, MachineMesh)
                         and mesh.device_mesh is not None)
        self._param_pl, self._out_pl = {}, {}
        if not self._on_mesh:
            return
        if mesh.device.type != self.device.type:
            raise ValueError(f"the model runs on {self.device} and its mesh "
                             f"on {mesh.device}")
        self.device = mesh.device
        # the lines the ops' own collectives run over (new_group is
        # collective: every rank compiles here)
        mesh.make_axis_groups(sorted({a for op in self.layers
                                      for a in op.collective_axes}))
        for op in self.layers:
            for w in op.weights:
                self._param_pl[w.name] = mesh.sharding(
                    param_spec(w, op.parallel_config, mesh))
            if op.parallel_config is not None:
                for t in op.outputs:
                    self._out_pl[t.uid] = mesh.sharding(
                        output_spec(t, op.parallel_config, mesh))

    def _resolve_host_placements(self) -> set:
        """The parameters of host-placed ops (device type CPU or ZCM
        memory): they live in pinned host memory, on a mesh as a plain
        tensor on every rank (a DTensor lives on the mesh's device
        type).  An Embedding gathers its rows on the host; any other
        op's parameters are copied to the device for its forward
        (``_host_stream``).  Every host parameter visits the device for
        the optimizer's update, whose state lives there, and goes back
        to its pinned buffer after the step, as in the JAX package."""
        names, self._host_stream = set(), []
        for op in self.layers:
            if not host_placed(op.parallel_config) or not op.weights:
                continue
            names.update(w.name for w in op.weights)
            if not isinstance(op, Embedding):
                # a list, in the layers' order: every rank copies them
                # to the device, and reduces their gradients, in one order
                self._host_stream.extend(w.name for w in op.weights)
        return names

    def _run_verifier(self, verify: str) -> None:
        """The static verification pass over the resolved graph and
        strategy, as the JAX package's ``_run_verifier``."""
        if verify == "off":
            return
        from .analysis import VerificationError, verify_compile
        report = verify_compile(self)
        self.verify_report = report
        if verify == "error" and report.errors:
            raise VerificationError(report)
        bad = report.errors + report.warnings
        if bad:
            import warnings
            warnings.warn(
                f"strategy/graph verification found {len(report.errors)} "
                f"error(s), {len(report.warnings)} warning(s):\n"
                + "\n".join(d.render() for d in bad[:20])
                + ("\n..." if len(bad) > 20 else "")
                + "\n(verify='error' makes these fatal; verify='off' "
                  "silences them)",
                stacklevel=3)

    def _sparse_embedding_specs(self) -> List[tuple]:
        """The embedding tables that train on the sparse update path
        (``FFConfig.sparse_embedding_updates``: None is auto, False
        turns it off): the step differentiates with respect to the
        gathered rows and adds ``-lr * grad`` to those rows alone, an
        exact rewrite of plain SGD that never writes the rest of the
        table.  Eligible, as in the JAX package: plain SGD (momentum 0,
        weight decay 0, which would touch every row), no gradient
        accumulation, and a trainable, device-placed table used by one
        op whose ids are a graph input.  On a mesh every table takes the
        dense update, whose values these are.  Returns [(op name, table
        name, input position)]."""
        return self._row_update_specs(host=False)

    def _host_row_specs(self) -> List[tuple]:
        """The host-placed tables that take the row update, under the
        conditions of :meth:`_sparse_embedding_specs`: ``table[id] -= lr
        * grad`` in place on the host, the values of the dense update
        (the JAX package updates such a table on its dense path).  Any
        other host table trains on the dense path: autograd builds its
        whole gradient on the host and the optimizer updates it there."""
        return self._row_update_specs(host=True)

    def _row_update_specs(self, host: bool) -> List[tuple]:
        """The row-update tables among the device-placed (``host``
        False) or host-placed ones: [(op name, table name, input
        position)]."""
        cfg = self.config
        opt = self.optimizer
        if (cfg.sparse_embedding_updates is False or self._on_mesh
                or cfg.gradient_accumulation_steps > 1
                or not isinstance(opt, SGDOptimizer)
                or opt.momentum != 0.0 or opt.weight_decay != 0.0):
            return []
        input_uids = [t.uid for t in self.input_tensors]
        owners: Dict[str, int] = {}
        for op in self.layers:
            for w in op.weights:
                owners[w.name] = owners.get(w.name, 0) + 1
        specs = []
        for op in self.layers:
            if (not isinstance(op, Embedding)
                    or host_placed(op.parallel_config) != host):
                continue
            tname = op.w_table.name
            if (op.inputs[0].uid in input_uids and owners[tname] == 1
                    and op.w_table.trainable):
                specs.append((op.name, tname,
                              input_uids.index(op.inputs[0].uid)))
        return specs

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init_layers(self, seed: Optional[int] = None) -> None:
        """Create every parameter on the model's device from ``seed``
        (default ``config.seed``), and the optimizer's state for the
        trainable ones.  On a mesh every rank draws the same full values
        and keeps its own shard of each."""
        if not self._compiled:
            raise RuntimeError("call compile() first")
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator().manual_seed(int(seed))
        params: Dict[str, torch.Tensor] = {}
        for p in self.parameters:
            init = p.initializer or GlorotUniform()
            dtype = torch_dtype(self.config.param_dtype
                                if p.dtype == "float32" else p.dtype)
            value = init(gen, p.shape, dtype)
            params[p.name] = (self._pin(value) if p.name in self._host_params
                              else self._place_param(p.name, value))
        self._params = params
        self._opt_state = self.optimizer.init_state(
            {k: self._on_device(k, v) for k, v in params.items()
             if k in self._trainable_names()})
        self._step = 0

    def _on_device(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """A host-placed parameter's value (or gradient) copied to the
        device; any other value as it is."""
        if name not in self._host_params:
            return value
        return value.to(self.device, non_blocking=True)

    def _stream_in(self, value: torch.Tensor) -> torch.Tensor:
        """A host-placed parameter of an op that runs on the device: its
        copy there (differentiable, its gradient goes back to the host),
        on a mesh a replicated DTensor, whose gradient comes back whole
        on every rank, reduced over the data ranks as every replicated
        parameter's is."""
        value = value.to(self.device, non_blocking=True)
        if not self._on_mesh:
            return value
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(value, self.mesh.device_mesh,
                                  self.mesh.replicated(), run_check=False)

    def _pin(self, value: torch.Tensor) -> torch.Tensor:
        """A host-placed parameter's home: pinned host memory when the
        model runs on CUDA (pinning needs it), plain host memory on the
        CPU."""
        value = value.to("cpu")
        return value.pin_memory() if self.device.type == "cuda" else value

    def _place_param(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """A parameter's value on the model's device; on a mesh a full
        value becomes this rank's shard of it and a DTensor is
        redistributed to the parameter's placements."""
        if not self._on_mesh:
            return value.to(self.device)
        pl = self._param_pl[name]
        if is_dtensor(value):
            return redistribute(value, pl)
        return distribute(value.to(self.device), self.mesh, pl)

    def _store(self, values: Dict[str, torch.Tensor]) -> None:
        """Install new parameter values; a host-placed parameter's value
        is copied into its pinned buffer, so the table never leaves
        pinned host memory, and on a mesh each value keeps its
        parameter's placements."""
        for k, v in values.items():
            if k in self._host_params:
                self._params[k].copy_(v)
            elif self._on_mesh:
                self._params[k] = self._place_param(k, v)
            else:
                self._params[k] = v

    def _trainable_names(self) -> set:
        return {p.name for p in self.parameters if p.trainable}

    def _resolve(self, name: str) -> str:
        if name in self._params:
            return name
        for k in self._params:
            if k.endswith("/" + name) or k.split("/")[0] == name:
                return k
        raise KeyError(name)

    def get_weights(self, name: str) -> np.ndarray:
        """An owned copy of a parameter's full value (the sparse update
        writes tables in place).  On a mesh the shards are gathered, a
        collective: every rank calls it."""
        return np.array(to_host(gather(self._params[self._resolve(name)])))

    def set_weights(self, name: str, value) -> None:
        """Install a parameter's full value (on a mesh every rank passes
        the same value and keeps its shard)."""
        key = self._resolve(name)
        cur = self._params[key]
        arr = np.asarray(value)
        if arr.dtype.kind not in "biuf":  # e.g. ml_dtypes bfloat16
            arr = arr.astype(np.float32)
        val = torch.tensor(arr)  # a copy: the caller keeps its array
        dev = self.device if is_dtensor(cur) else cur.device
        self._store({key: val.to(device=dev,
                                 dtype=cur.dtype).reshape(cur.shape)})

    # ------------------------------------------------------------------
    # live resharding: a change of mesh factorization in process; another
    # device count goes through the supervisor (parallel/elastic.py)
    # ------------------------------------------------------------------
    def _live_mesh_shape(self) -> Dict[str, int]:
        """Axis sizes > 1 of the current mesh (the spelling manifests and
        reshard events record; {} for one device)."""
        return {a: s for a, s in self.mesh.sizes.items() if s > 1}

    def _reshard_budget(self) -> int:
        """The search budget a reshard point may spend: the dedicated
        ``reshard_search_budget`` when set, else ``search_budget``."""
        cfg = self.config
        return (cfg.reshard_search_budget
                if cfg.reshard_search_budget is not None
                else cfg.search_budget)

    def reshard(self, new_mesh=None, num_devices: Optional[int] = None,
                research: Optional[bool] = None, verify: str = "warn",
                redistribute: bool = True) -> Dict:
        """Move live training state onto another mesh of the same world,
        in process, between steps: the JAX package's ``FFModel.reshard``.

        Pass exactly one of ``new_mesh`` (a :class:`MachineMesh` or a
        mesh-shape dict) or ``num_devices`` (pure data parallel
        ``{"n": num_devices}``).  The port runs one process per device
        and a process group keeps its size for life, so the target must
        use every rank of the world (``{"n": 4}`` -> ``{"n": 2, "c":
        2}``, ``{"c": 4}`` or ``{"n": 2, "p": 2}`` on four ranks); another
        device count raises ValueError: it goes through the supervisor
        (``parallel.elastic.run_elastic`` relaunches the world at that
        size, and the new ranks reshard on resume from the checkpoint).
        A re-search of the strategies (``research=True``, or a
        ``reshard_search_budget``/``search_budget`` above 0) searches
        them for the target (``optimize_strategies`` with that budget):
        given ``num_devices`` the searched mesh is adopted, given
        ``new_mesh`` the search is pinned to it.

        Steps, in the JAX order: **verify** the strategies against the
        new mesh (``verify="error"`` aborts with the model unchanged),
        **rebuild** the placements (a failure there rolls the model back
        whole: mesh, per-op configs, host placements), then
        **redistribute**: every parameter and optimizer slot is gathered
        to its full value and placed under the new placements
        (value-lossless: the steps after it equal a run that was always
        on the new mesh from this state).  ``redistribute=False`` gives
        zero-filled state under the new placements, for a caller about
        to restore every value.  On a mesh every rank calls it.  Emits
        the ``reshard`` event on the ``elastic`` logger and returns its
        report (old and new mesh and device counts, ``researched``, the
        step and the strategy digest)."""
        self._check_not_quantized("reshard")
        if not self._compiled or self._opt_state is None:
            raise RuntimeError("call compile() and init_layers() first")
        if (new_mesh is None) == (num_devices is None):
            raise ValueError("pass exactly one of new_mesh / num_devices")
        if research is None:
            research = self._reshard_budget() > 0
        if verify not in ("warn", "error", "off"):
            raise ValueError(
                f"verify must be 'warn', 'error' or 'off', got {verify!r}")
        if new_mesh is not None:
            shape = dict(new_mesh.sizes if isinstance(new_mesh, MachineMesh)
                         else new_mesh)
            ndev = math.prod(int(v) for v in shape.values())
        else:
            ndev = int(num_devices)
            if ndev < 1:
                raise ValueError(f"num_devices must be >= 1, got {ndev}")
            shape = {"n": ndev}
        world = distributed.world_size()
        if ndev != world:
            raise ValueError(
                f"reshard to {ndev} device(s) (new_mesh or num_devices) "
                f"in a world of {world} "
                f"rank(s): the port runs one process per device and a "
                f"process group keeps its size, so an in-process reshard "
                f"takes a mesh of {world} device(s); another device "
                f"count goes through the supervisor "
                f"(parallel.elastic.run_elastic relaunches the world at "
                f"that size and the new ranks reshard on resume from the "
                f"checkpoint)")
        self.wait_for_checkpoint()  # the pending writer reads _params
        old_shape = self._live_mesh_shape()
        old_ndev = self.mesh.mesh_product
        new_strategies = None
        if research:
            # re-search for the target: pinned to an explicit mesh,
            # adopting the searched factorization for a device count
            from .search.mcmc import optimize_strategies
            new_strategies, best_mesh = optimize_strategies(
                self, self.config, num_devices=ndev,
                budget=self._reshard_budget(), with_mesh=True,
                mesh_shape=shape if new_mesh is not None else None)
            if new_mesh is None:
                shape = {a: s for a, s in best_mesh.items() if s > 1} \
                    or {"n": 1}
        mesh = (MachineMesh(shape, device=self.device) if world > 1
                else AbstractMesh(shape, num_devices=1))
        saved = {k: getattr(self, k) for k in (
            "mesh", "device", "_on_mesh", "_param_pl", "_out_pl",
            "_host_params", "_host_stream", "_host_rows", "_sparse_specs",
            "verify_report")}
        configs = [op.parallel_config for op in self.layers]

        def rollback():
            for k, v in saved.items():
                setattr(self, k, v)
            for op, pc in zip(self.layers, configs):
                op.parallel_config = pc

        self.mesh = mesh
        if new_strategies is not None:
            for op in self.layers:
                op.parallel_config = new_strategies.get(op.name)
        try:
            self._bind_mesh()
            self._host_params = self._resolve_host_placements()
            self._sparse_specs = self._sparse_embedding_specs()
            self._host_rows = self._host_row_specs()
            self._run_verifier(verify)
        except Exception:
            rollback()
            raise
        try:
            new_params = {}
            for name, cur in self._params.items():
                if name in self._host_params:
                    # host-placed: a plain pinned tensor on every rank
                    new_params[name] = (cur if redistribute
                                        else self._pin(torch.zeros_like(cur)))
                    continue
                full = (gather(cur) if redistribute
                        else torch.zeros(cur.shape, dtype=cur.dtype,
                                         device=self.device))
                new_params[name] = self._place_param(name, full)
            proto = self.optimizer.init_state(
                {k: self._on_device(k, v) for k, v in new_params.items()
                 if k in self._trainable_names()})
            old_leaves = _flatten_state(self._opt_state)
            proto_leaves = _flatten_state(proto)
            if len(old_leaves) != len(proto_leaves):
                raise RuntimeError(
                    f"optimizer state has {len(old_leaves)} slots, the "
                    f"rebuilt one {len(proto_leaves)}")
            new_leaves = []
            for old, pv in zip(old_leaves, proto_leaves):
                if not redistribute or not isinstance(pv, torch.Tensor):
                    new_leaves.append(old if not isinstance(
                        pv, torch.Tensor) else pv)
                    continue
                full = gather(old).to(device=self.device, dtype=pv.dtype)
                new_leaves.append(
                    distribute(full, self.mesh, pv.placements)
                    if is_dtensor(pv) else full.to(pv.device))
            new_opt = _unflatten_state(proto, iter(new_leaves))
        except Exception:
            rollback()
            raise
        self._params = new_params
        self._opt_state = new_opt
        self._fwd_compiled = {}
        self.__dict__.pop("_gen_decoders", None)
        self._batch = None
        self._cached_grads = None
        self.config.mesh_shape = self._live_mesh_shape() or {"n": 1}
        report = {"old_mesh": old_shape,
                  "new_mesh": self._live_mesh_shape(),
                  "old_devices": old_ndev,
                  "new_devices": self.mesh.mesh_product,
                  "researched": bool(research), "step": self._step,
                  "strategy_digest": self._strategy_digest()}
        from .fflogger import get_logger
        get_logger("elastic").event("reshard", **report)
        return report

    def _reshard_if_mesh_changed(self, data: Dict[str, np.ndarray],
                                 path: str = "<checkpoint>") -> bool:
        """Reshard-on-resume detection: compare an already-read
        checkpoint's manifest topology with the mesh this model runs on.
        On a change, emit one ``reshard_on_resume`` event on the
        ``elastic`` logger (the saved and current mesh, devices and
        strategy digests).  The arrays are whole, so they load under
        the current placements as they are; a configured re-search
        (``reshard_search_budget``/``search_budget`` > 0) re-runs the
        search for the current devices and reshards onto its result.
        Returns True when the topology differed."""
        from .resilience import manifest_meta
        meta = manifest_meta(data)
        if meta is None:
            return False
        cur_shape = self._live_mesh_shape()
        cur_ndev = self.mesh.mesh_product
        saved_shape = meta.get("mesh_shape")
        saved_ndev = meta.get("num_devices")
        mesh_changed = (
            (saved_ndev is not None and saved_ndev != cur_ndev)
            or (saved_shape is not None and saved_shape != cur_shape))
        cur_digest = self._strategy_digest()
        saved_digest = meta.get("strategy_digest")
        if not (mesh_changed or saved_digest not in (None, cur_digest)):
            return False
        research = mesh_changed and self._reshard_budget() > 0
        from .fflogger import get_logger
        get_logger("elastic").event(
            "reshard_on_resume", path=path,
            saved_mesh=saved_shape, saved_devices=saved_ndev,
            mesh=cur_shape, devices=cur_ndev,
            saved_digest=saved_digest, digest=cur_digest,
            research=bool(research))
        if research:
            self.reshard(num_devices=cur_ndev, redistribute=False)
        return True

    def _apply_fault_reshard(self, kind: str,
                             devices: Optional[int] = None) -> None:
        """Consume a ``grow_at_step``/``shrink_at_step`` request
        (``faults.reshard_at_window``): by default double or halve the
        device count, landing on the data axis (``mesh.scaled_shape``).
        A target equal to the world reshards in process (re-searching the
        strategies when a reshard or search budget is set); any other size
        goes through the supervisor: every rank saves the step's
        ``elastic_step<N>.npz`` in ``FF_ELASTIC_CKPT_DIR``, rank 0
        records the size asked for, and every rank exits with
        ``parallel.elastic.RESIZE_EXIT_CODE``; ``run_elastic`` relaunches
        that world, which reshards on resume."""
        cur = self.mesh.mesh_product
        if devices is None:
            devices = cur * 2 if kind == "grow_at_step" else max(1, cur // 2)
        devices = max(1, int(devices))
        if devices == cur:
            return
        if devices == distributed.world_size():
            if self._reshard_budget() > 0:
                # a configured re-search picks the target's strategies
                self.reshard(num_devices=devices)
            else:
                self.reshard(new_mesh=scaled_shape(self.mesh.sizes,
                                                   devices))
            return
        import os
        import sys

        from .parallel import elastic
        ckpt_dir = os.environ.get("FF_ELASTIC_CKPT_DIR")
        if not ckpt_dir or not os.environ.get("FF_HEARTBEAT_DIR"):
            raise ValueError(
                f"{kind} to {devices} device(s) from a world of "
                f"{distributed.world_size()}: another world size goes "
                f"through the supervisor (run the ranks under "
                f"parallel.elastic.run_elastic with a checkpoint_dir)")
        self.save_checkpoint(os.path.join(ckpt_dir,
                                          f"elastic_step{self._step}.npz"))
        if distributed.world_size() == 1 or \
                torch.distributed.get_rank() == 0:
            elastic.request_resize(devices, self._step)
        distributed.coordination_barrier("resize")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(elastic.RESIZE_EXIT_CODE)

    def _maybe_reshard_fault(self, start: int, end: int) -> None:
        """Consume every ``grow_at_step``/``shrink_at_step`` fault of the
        just-completed window ``(start, end]``, between steps."""
        for req in faults.reshard_at_window(start, end):
            self._apply_fault_reshard(*req)

    def _window_faults(self, start: int, end: int) -> None:
        """The train loop's fault hooks after steps ``(start, end]``:
        kill, hang and slow rank, then the reshards.  Without
        ``FF_FAULT`` this is the one cached ``plan()`` check."""
        if faults.plan():
            faults.on_window(start, end)
            self._maybe_reshard_fault(start, end)

    @property
    def num_parameters(self) -> int:
        return sum(p.volume for p in self.parameters)

    def quantize_weights(self, mode: str = "int8") -> Dict:
        """Int8 weight-only quantization for serving: every eligible
        matmul kernel (``serving.quantize.eligible_weights``: 2-D Linear
        kernels that are not host-placed) is replaced in ``_params`` by
        its per-output-channel symmetric int8 tensor on the same device,
        with its float32 ``<name>::scale`` vector beside it.  The
        float32 kernels are released: no reference stays in ``_params``
        or a cached forward, so the resident bytes drop as the report's
        ``bytes_before``/``bytes_after`` say.  Linear's forward then
        multiplies through ``ops.common.dequant_matmul``.

        Returns the quality report (``max_abs_err``, ``error_bound`` =
        the largest scale / 2, ``bound_ok``, the bytes, per-weight
        rows); the serving engine refuses to warm up when the bound is
        violated.  One-way for this instance: ``fit``, ``train_batch``,
        ``train_window``, ``evaluate`` and ``save_checkpoint`` refuse a
        quantized model.  Idempotent: a second call with the same mode
        returns the same report; another mode raises ValueError."""
        if not (self._compiled and self._params):
            raise RuntimeError("compile() + init_layers() before "
                               "quantize_weights()")
        if getattr(self, "_quantized", ""):
            if self._quantized != mode:
                raise ValueError(
                    f"weights already quantized as {self._quantized!r}")
            return self._quant_report
        from .fflogger import get_logger
        from .serving.quantize import quantize_params
        new_params, report = quantize_params(self, mode)
        self._params = new_params
        self._quantized = mode
        self._quant_report = report
        # the bucket forwards closed over nothing but self; drop them so
        # no cached callable outlives the float32 parameters' shapes
        self._fwd_compiled = {}
        get_logger("serve").event(
            "quantize_weights", mode=mode,
            weights=len(report["weights"]),
            bytes_before=report["bytes_before"],
            bytes_after=report["bytes_after"],
            max_abs_err=report["max_abs_err"],
            error_bound=report["error_bound"])
        return report

    def _check_not_quantized(self, verb: str) -> None:
        if getattr(self, "_quantized", ""):
            raise RuntimeError(
                f"{verb}() is not available on a weight-quantized model "
                f"(quantize_weights({self._quantized!r}) is one-way for "
                f"this instance: serving only); build and train a fresh "
                f"model")

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    @staticmethod
    def _ckpt_path(path: str) -> str:
        # np.savez silently appends '.npz' to suffix-less paths; normalize
        # here so save/load agree on the on-disk name
        return path if path.endswith(".npz") else path + ".npz"

    def _strategy_digest(self) -> str:
        """The JAX package's ``strategy_digest`` of the resolved per-op
        configs, recorded in the manifest, so a checkpoint written under
        a strategy carries the same digest in either package."""
        from .strategy.proto import strategy_digest
        return strategy_digest(
            {op.name: op.parallel_config for op in self.layers})

    def save_checkpoint(self, path: str, async_write: bool = False,
                        keep_last: Optional[int] = None) -> None:
        """Write the parameters (``param:<name>``, BatchNorm's running
        statistics included), the optimizer state (``opt:<i>``, its
        leaves in ``jax.tree_util`` flatten order), the step
        (``meta:step``) and the integrity manifest (``meta:manifest``:
        per-array CRC32s, the step, and the one-device topology with the
        default plan's strategy digest) to one ``.npz``: the JAX
        package's format, so its ``load_checkpoint`` and
        ``resilience.verify_checkpoint`` take the file.

        The device-to-host copy is synchronous; with ``async_write`` the
        CRC pass, ``np.savez`` and the atomic rename run in a non-daemon
        background thread, whose failure is re-raised at the next save,
        load or :meth:`wait_for_checkpoint`.  ``keep_last=K`` prunes the
        file's ``<name>_step<N>.npz`` family to its newest K, and stale
        ``*.tmp.npz`` orphans of the family are swept on every save.

        On a mesh every rank calls it: the shards are gathered on every
        rank, rank 0 writes the full arrays (the manifest records the
        mesh, its devices and the world's processes), and the others
        wait for the file; ``async_write`` applies to one-process runs."""
        self._check_not_quantized("save_checkpoint")
        if self._opt_state is None:
            raise RuntimeError("call compile() and init_layers() first")
        flat: Dict[str, np.ndarray] = {}
        for k, v in self._params.items():
            # an owned copy: the sparse update writes tables in place
            flat[f"param:{k}"] = np.array(to_host(gather(v)))
        for i, leaf in enumerate(_flatten_state(self._opt_state)):
            flat[f"opt:{i}"] = _leaf_to_host(leaf)
        flat["meta:step"] = np.asarray(self._step, np.int64)
        self.wait_for_checkpoint()  # one writer at a time, in order
        final = self._ckpt_path(path)
        step = self._step
        digest = self._strategy_digest()
        mesh_shape = self._live_mesh_shape()
        world = distributed.world_size()

        def write():
            flat[MANIFEST_KEY] = np.asarray(
                build_manifest(flat, step, mesh_shape=mesh_shape,
                               num_devices=self.mesh.mesh_product,
                               process_count=world,
                               strategy_digest=digest))
            _atomic_savez(final, flat)
            faults.maybe_corrupt_checkpoint(final, step)
            if keep_last is not None:
                _prune_step_family(final, keep_last)

        if world > 1:
            if torch.distributed.get_rank() == 0:
                _cleanup_stale_tmps(final)
                write()
            distributed.coordination_barrier("save_checkpoint")
            return
        _cleanup_stale_tmps(final)
        if not async_write:
            write()
            return

        def guarded():
            try:
                write()
            except BaseException as e:
                # loud even if nothing ever joins, and kept for the next
                # save, load or wait to re-raise
                traceback.print_exc()
                self._ckpt_exc = e

        # non-daemon: the interpreter joins it at exit, so a script whose
        # last act is an async save still publishes
        self._ckpt_writer = threading.Thread(target=guarded,
                                             name="ff-ckpt-writer")
        self._ckpt_writer.start()

    def _raise_ckpt_exc(self) -> None:
        exc = self._ckpt_exc
        if exc is not None:
            self._ckpt_exc = None
            raise RuntimeError("checkpoint write failed") from exc

    def wait_for_checkpoint(self) -> None:
        """Join a pending async checkpoint writer; re-raises its
        failure."""
        w = self._ckpt_writer
        if w is not None:
            w.join()
            self._ckpt_writer = None
        self._raise_ckpt_exc()

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint written by either package's
        ``save_checkpoint``.  The whole file is read and its manifest's
        CRCs checked first (a truncated or corrupt file raises
        ``resilience.CorruptCheckpointError`` naming the path), then its
        parameter and optimizer-state sets and shapes are checked
        against this model, all before any state changes.  The arrays
        are whole whatever mesh wrote them, so a checkpoint loads on any
        mesh: each rank reads the file and keeps its shards.  A file
        saved on another mesh (the manifest's topology) emits the
        ``reshard_on_resume`` event first (``_reshard_if_mesh_changed``)."""
        if self._opt_state is None:
            raise RuntimeError("call compile() and init_layers() first")
        self.wait_for_checkpoint()  # never read under a pending writer
        path = self._ckpt_path(path)
        data = read_npz_verified(path, what="checkpoint")
        self._validate_restore(data)
        self._reshard_if_mesh_changed(data, path)
        self._restore_from_host(data)

    def _validate_restore(self, data: Dict[str, np.ndarray]) -> None:
        """Raise ``ValueError`` unless ``data`` matches this model's
        parameter names and shapes and its optimizer's slot count and
        shapes."""
        keys = set(data) - {MANIFEST_KEY}
        ckpt_params = {k[len("param:"):] for k in keys
                       if k.startswith("param:")}
        cur_params = set(self._params)
        if ckpt_params != cur_params:
            missing = sorted(cur_params - ckpt_params)
            extra = sorted(ckpt_params - cur_params)
            raise ValueError(
                f"checkpoint does not match this model: "
                f"missing params {missing[:5]}, unexpected {extra[:5]}")
        bad_shapes = [
            (n, data[f"param:{n}"].shape, tuple(self._params[n].shape))
            for n in sorted(ckpt_params)
            if data[f"param:{n}"].shape != tuple(self._params[n].shape)]
        if bad_shapes:
            raise ValueError(
                f"checkpoint does not match this model: shape "
                f"mismatches {bad_shapes[:5]}")
        leaves = _flatten_state(self._opt_state)
        n_opt = sum(1 for k in keys if k.startswith("opt:"))
        if n_opt != len(leaves):
            raise ValueError(
                f"optimizer state mismatch: checkpoint has {n_opt} "
                f"slots, this optimizer has {len(leaves)} (was it saved "
                f"with a different optimizer?)")
        for i, leaf in enumerate(leaves):
            if data[f"opt:{i}"].shape != _leaf_shape(leaf):
                raise ValueError(
                    f"optimizer state mismatch: slot {i} shape "
                    f"{data[f'opt:{i}'].shape} != {_leaf_shape(leaf)}")

    def _restore_from_host(self, data: Dict[str, np.ndarray]) -> None:
        """Apply already-read, verified and validated checkpoint arrays:
        each value takes the current parameter's (or slot's) dtype,
        device and placements; Adam's step count comes back as an int."""
        def put(arr, like: torch.Tensor) -> torch.Tensor:
            arr = np.asarray(arr)
            if arr.dtype.kind not in "biuf":  # e.g. ml_dtypes bfloat16
                arr = arr.astype(np.float32)
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if is_dtensor(like):
                return distribute(t.to(device=self.device, dtype=like.dtype),
                                  self.mesh, like.placements)
            return t.to(device=like.device, dtype=like.dtype)

        self._store({name: put(data[f"param:{name}"], cur)
                     for name, cur in self._params.items()})
        leaves = _flatten_state(self._opt_state)
        new = [put(data[f"opt:{i}"], leaf) if isinstance(leaf, torch.Tensor)
               else int(data[f"opt:{i}"]) for i, leaf in enumerate(leaves)]
        self._opt_state = _unflatten_state(self._opt_state, iter(new))
        self._step = int(data["meta:step"])

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def _forward_values(self, params: Dict[str, torch.Tensor],
                        inputs: Sequence[torch.Tensor],
                        training: bool = False,
                        seed: Optional[int] = None,
                        updates: Optional[Dict[str, torch.Tensor]] = None,
                        embedding_rows: Optional[
                            Dict[str, torch.Tensor]] = None,
                        aux_losses: Optional[Dict[str, torch.Tensor]] = None,
                        keep_uids: Optional[Sequence[int]] = None
                        ) -> Dict[int, torch.Tensor]:
        """Run the layer list on ``inputs``; returns the tensors' values
        by uid.  Each op runs in its resolved compute dtype.  In training
        the ops' non-trainable state updates land in ``updates`` and
        their auxiliary losses in ``aux_losses``, and the Embeddings named
        in ``embedding_rows`` read their rows from it.

        With ``config.remat`` and ``keep_uids`` (the training step passes
        the loss and final tensors) the layer list runs in segments
        (``_execute_remat``) and only the segment boundaries and
        ``keep_uids`` come back; otherwise every tensor does.

        On a mesh the inputs are the full batch (the same on every rank)
        and are placed by their batch spec first; the values are
        DTensors."""
        base = self.config.compute_dtype
        ctx = OpContext(device=self.device, seed=seed,
                        training=training, compute_dtype=base,
                        conv_layout=self.resolved_conv_layout,
                        flash_attention=self.config.flash_attention,
                        updates={} if updates is None else updates,
                        embedding_rows=embedding_rows,
                        aux_losses={} if aux_losses is None else aux_losses,
                        mesh=self.mesh if self._on_mesh else None,
                        out_placements=self._out_pl)
        if self._on_mesh:
            inputs = self._place_batch(inputs, infer=not training)
        if self._host_stream:
            params = {**params, **{k: self._stream_in(params[k])
                                   for k in self._host_stream}}
        values = {t.uid: v for t, v in zip(self.input_tensors, inputs)}
        if (self.config.remat and keep_uids is not None
                and len(self.layers) > 3):
            return self._execute_remat(params, values, ctx, keep_uids)
        self._run_ops(self.layers, params, values, ctx)
        return values

    @staticmethod
    def _run_ops(ops, params, values: Dict[int, torch.Tensor],
                 ctx: OpContext) -> None:
        """Run ``ops`` in order into ``values``; on a mesh each output of
        an op with a strategy is redistributed to its output spec, the
        counterpart of the JAX package's ``with_sharding_constraint``."""
        base = ctx.compute_dtype
        for op in ops:
            ctx.compute_dtype = resolve_op_dtype(op, base)
            outs = op.forward(params, [values[t.uid] for t in op.inputs],
                              ctx)
            for t, v in zip(op.outputs, outs):
                pl = ctx.out_placements.get(t.uid)
                if pl is not None:
                    v = redistribute(v, pl)
                values[t.uid] = v
        ctx.compute_dtype = base

    def remat_segments(self) -> List[List[Op]]:
        """The layer list cut into ``max(2, isqrt(N))`` segments at the
        JAX package's bounds (``_execute_remat``); under ``remat`` every
        segment but the last runs checkpointed."""
        n = len(self.layers)
        nseg = max(2, math.isqrt(n))
        bounds = [round(i * n / nseg) for i in range(nseg + 1)]
        return [self.layers[a:b] for a, b in zip(bounds, bounds[1:])
                if b > a]

    def _execute_remat(self, params, values: Dict[int, torch.Tensor],
                       ctx: OpContext, keep_uids) -> Dict[int, torch.Tensor]:
        """sqrt(N)-segmented rematerialisation, the counterpart of the
        JAX package's ``_execute_remat``: each segment but the last runs
        under ``torch.utils.checkpoint`` (non-reentrant), so only the
        tensors that cross a segment boundary, and ``keep_uids``, live
        from the forward to the backward, and a segment's interior is
        recomputed when its backward runs.  The last segment runs plain:
        its activations feed the first backward step at once.  So does a
        segment that holds a pipeline over more than one rank: a
        recomputation would rerun its stages' hops at a point of the
        backward where the neighbouring ranks wait in theirs.  Each
        segment runs on a context of its own, and its ``updates`` and
        ``aux_losses`` come out with its outputs (a recomputation's are
        dropped).  No op draws from torch's global random state — each
        draws from its op generator, seeded afresh from the step seed at
        every call — so a recomputed segment redraws the same dropout
        masks, and checkpoint need not save and restore that state."""
        segments = self.remat_segments()
        keep = set(keep_uids)
        seg_in, seg_out = [], []
        for seg in segments:
            produced = {t.uid for op in seg for t in op.outputs}
            seg_in.append({t.uid for op in seg for t in op.inputs}
                          - produced)
            seg_out.append(produced)
        for i, seg in enumerate(segments):
            needed_later = set(keep)
            for j in range(i + 1, len(segments)):
                needed_later |= seg_in[j]
            in_uids = sorted(u for u in seg_in[i] if u in values)
            out_uids = sorted(seg_out[i] & needed_later)

            def seg_fn(*carry, seg=seg, in_uids=in_uids, out_uids=out_uids):
                ictx = dataclasses.replace(ctx, updates={}, aux_losses={})
                vals = dict(zip(in_uids, carry))
                self._run_ops(seg, params, vals, ictx)
                return ([vals[u] for u in out_uids], ictx.updates,
                        ictx.aux_losses)

            carry = tuple(values[u] for u in in_uids)
            if i == len(segments) - 1 or (
                    self._on_mesh and self.mesh.axis_size("p") > 1
                    and any("p" in op.collective_axes for op in seg)):
                outs, upd, aux = seg_fn(*carry)
            else:
                outs, upd, aux = torch.utils.checkpoint.checkpoint(
                    seg_fn, *carry, use_reentrant=False,
                    preserve_rng_state=False)
            ctx.updates.update(upd)
            ctx.aux_losses.update(aux)
            values.update(zip(out_uids, outs))
        return values

    def _forward(self, params: Dict[str, torch.Tensor],
                 inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The inference forward: the final tensor of the layer list
        (its full value on every rank of a mesh)."""
        with _mesh_context(self._on_mesh):
            return gather(self._forward_values(params, inputs)[
                self._final_tensor.uid])

    def forward_compiled(self, bucket_bs: int) -> Callable:
        """The inference forward for batches of exactly ``bucket_bs``
        rows, cached per bucket.  Call as ``fwd(model._params, batch)``
        with ``batch`` a tuple of input tensors on the model's device;
        it runs under ``torch.inference_mode()`` (``no_grad`` on a mesh)
        and returns the output tensor on the device.  The serving engine warms one per shape
        bucket and ``predict()`` shares the cache."""
        if not self._compiled:
            raise RuntimeError("call compile() first")
        bs = int(bucket_bs)
        if bs < 1:
            raise ValueError(f"bucket batch size must be >= 1, got "
                             f"{bucket_bs}")
        fwd = self._fwd_compiled.get(bs)
        if fwd is None:
            shapes = [(bs,) + tuple(t.shape[1:]) for t in self.input_tensors]

            def fwd(params, batch):
                got = [tuple(b.shape) for b in batch]
                if got != shapes:
                    raise ValueError(f"bucket {bs} forward expects inputs "
                                     f"shaped {shapes}, got {got}")
                # DTensor views cannot be taken in inference mode
                with (torch.no_grad() if self._on_mesh
                      else torch.inference_mode()):
                    return self._forward(params, batch)

            self._fwd_compiled[bs] = fwd
        return fwd

    @staticmethod
    def _pad_tail(arrays, bs: int):
        """Zero-pad a ragged tail batch to the full batch size so every
        dispatch sees one of the bucket shapes."""
        out = []
        for a in arrays:
            a = np.asarray(a)
            short = bs - a.shape[0]
            if short > 0:
                a = np.concatenate(
                    [a, np.zeros((short,) + a.shape[1:], a.dtype)])
            out.append(a)
        return tuple(out)

    def _to_device(self, arrays) -> tuple:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in arrays)

    def _batch_entries(self, shape, dtype, infer: bool = False) -> list:
        """The spec entries of one batch array on the mesh, as the JAX
        package's ``_batch_entries``: the sample dim over ``n``, and the
        sequence dim over ``s`` for (n, s) integer ids and (n, s, d)
        activations; a dim its axis does not divide replicates.  For
        inference (``infer``) the sample dim replicates below 2 rows a
        shard, as the JAX package's ``_infer_batch_entries`` keeps a
        request's bits independent of its bucket."""
        ndim = len(shape)
        seq_shaped = ndim == 3 or (ndim == 2 and not dtype.is_floating_point)
        spec = batch_spec(ndim, self.mesh, seq_sharded=(
            seq_shaped and self.mesh.axis_size("s") > 1))
        entries = [ax if ax is None or shape[i] % self.mesh.axis_size(ax)
                   == 0 else None for i, ax in enumerate(spec)]
        if (infer and entries and entries[0] is not None
                and shape[0] < 2 * self.mesh.axis_size(entries[0])):
            entries[0] = None
        return entries

    def _place_batch(self, arrays, infer: bool = False) -> tuple:
        """Full batch tensors as DTensors placed by their batch spec
        (each rank keeps its block; a DTensor passes as it is)."""
        return tuple(a if is_dtensor(a) else distribute(
            a.to(self.device), self.mesh, self.mesh.sharding(
                self._batch_entries(tuple(a.shape), a.dtype, infer)))
            for a in arrays)

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Batched inference through the bucket forward for
        ``batch_size``.  Outputs stay on the device until one fetch at
        the end; bfloat16 outputs come back as float32."""
        xs = x if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self.input_tensors):
            raise ValueError(
                f"model has {len(self.input_tensors)} input(s), got "
                f"{len(xs)}")
        xs = [np.asarray(a, dtype=t.dtype)
              for a, t in zip(xs, self.input_tensors)]
        n = xs[0].shape[0]
        bs = batch_size or self.config.batch_size
        fwd = self.forward_compiled(bs)
        outs = []
        for it in range(-(-n // bs)):
            lo, hi = it * bs, min(n, (it + 1) * bs)
            arrs = tuple(a[lo:hi] for a in xs)
            if hi - lo < bs:
                arrs = self._pad_tail(arrs, bs)
            outs.append(fwd(self._params, self._to_device(arrs))[:hi - lo])
        self._surface_runtime_fallbacks()
        return to_host(torch.cat(outs, dim=0))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _device_batch(self, arrays) -> tuple:
        """Batch arrays (numpy or tensors) as tensors on the device."""
        return tuple(a.to(self.device) if isinstance(a, torch.Tensor)
                     else upload((a,), self.device)[0] for a in arrays)

    def _step_seed(self, step: int) -> int:
        """The random seed of training step ``step``, from
        ``config.seed`` and the step (the JAX step folds the step into
        its key the same way); each op derives its own generator from it
        and its output uid (``OpContext.op_generator``), and microbatch
        ``i`` of an accumulated step folds ``i`` in (``fold_seed``)."""
        return ((int(self.config.seed) << 32) + step) & 0x7FFF_FFFF_FFFF_FFFF

    def _check_accum_divisible(self, n: int, what: str) -> None:
        """Every entry point that feeds the train step checks its batch
        divides into ``gradient_accumulation_steps`` equal microbatches."""
        accum = self.config.gradient_accumulation_steps
        if accum > 1 and n % accum:
            raise ValueError(
                f"{what} {n} does not divide into "
                f"gradient_accumulation_steps={accum} equal microbatches")

    def _loss_and_grads(self, batch, seed: int, sparse: bool = False,
                        nvalid: Optional[int] = None, base: int = 0,
                        aux_scale: float = 1.0):
        """Forward with autograd on, the loss on ``_loss_tensor`` plus
        ``aux_scale`` times the ops' auxiliary losses, its gradients, the
        batch's metric sums and the ops' non-trainable state updates
        (BatchNorm's running statistics).  Returns (loss, sums, grads,
        updates, row_grads), all on the device; the loss is a detached
        0-d float32 tensor and the updates are detached.

        ``nvalid`` selects the masked padded-tail objective: only rows
        whose global index (``base`` plus the row) is below ``nvalid``
        count, and the loss is their sum over ``max(nvalid, 1)`` for a
        mean-reduced loss (their sum for a sum-reduced one), so the
        losses of an accumulated step's microbatches add.

        ``grads`` holds every trainable parameter's gradient (a
        host-placed table's on the host).  With ``sparse``, the tables of
        ``_sparse_specs`` and ``_host_rows`` are left out of it: their
        rows are gathered outside autograd (by the Embedding's id rules;
        a host table's on the host, then moved to the device) and handed
        to the ops as leaves, and ``row_grads`` holds the gradient of
        each op's rows, (n, [bag or s,] d), on the device.

        On a mesh the batch is placed by its batch spec, the loss and the
        metric sums reduce over the global batch (they come back as full
        values), and each gradient comes back under its parameter's
        placements: a data-parallel gradient is all-reduced there."""
        if self._on_mesh:
            batch = self._place_batch(batch)
        specs = self._sparse_specs + self._host_rows if sparse else []
        tables = {tname for _, tname, _ in specs}
        names = self._trainable_names() - tables
        trainable = {k: v.detach().requires_grad_(True)
                     for k, v in self._params.items() if k in names}
        params = {**self._params, **trainable}
        with torch.no_grad():
            rows = {op_name: (
                host_gather(self._params[tname], batch[pos], self.device)
                if tname in self._host_params
                else take_rows(self._params[tname].to(torch.float32),
                               batch[pos]))
                for op_name, tname, pos in specs}
        for r in rows.values():
            r.requires_grad_(True)
        labels = batch[-1]
        updates: Dict[str, torch.Tensor] = {}
        aux_losses: Dict[str, torch.Tensor] = {}
        with torch.enable_grad(), _mesh_context(self._on_mesh):
            values = self._forward_values(
                params, batch[:-1], training=True, seed=seed,
                updates=updates, embedding_rows=rows or None,
                aux_losses=aux_losses,
                keep_uids=(self._loss_tensor.uid, self._final_tensor.uid))
            logits = self._whole_rows(values[self._loss_tensor.uid])
            mb = logits.shape[0]
            if nvalid is None:
                loss = self._loss_fn(logits, labels)
            else:
                mask = ((torch.arange(mb, device=logits.device) + base)
                        < nvalid).to(torch.float32)
                total = torch.sum(self._per_example_loss(logits, labels)
                                  * mask)
                denom = (float(max(nvalid, 1))
                         if self._loss_reduction == "mean" else 1.0)
                loss = total / denom
            if aux_losses:
                loss = loss + sum(aux_losses.values()) * aux_scale
            if self._on_mesh:
                loss = redistribute(loss, self.mesh.replicated())
            leaves = list(trainable.values()) + list(rows.values())
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad(), _mesh_context(self._on_mesh):
            sums = metrics_mod.compute_batch_metrics(
                logits.detach(), labels, self.metrics, self.loss_type,
                nvalid=(None if nvalid is None
                        else min(max(nvalid - base, 0), mb)))
            sums = {k: gather(v) for k, v in sums.items()}
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        row_grads = dict(zip(rows, grads[len(trainable):]))
        grads = dict(zip(trainable, grads[:len(trainable)]))
        if self._on_mesh:
            grads = {k: g if k in self._host_params
                     else redistribute(g, self._param_pl[k])
                     for k, g in grads.items()}
        return (gather(loss.detach()), sums, grads,
                {k: v.detach() for k, v in updates.items()}, row_grads)

    def _accumulate(self, batch, seed: int, nvalid: Optional[int]):
        """Gradient accumulation over k equal microbatches, the JAX
        ``_step_core``'s scan: microbatch i runs with seed
        ``fold_seed(seed, i)``, the gradients add at parameter size, the
        metric sums add and BatchNorm keeps the last microbatch's
        running statistics.  A mean-reduced loss is the mean of the
        microbatch losses and the gradients are divided by k; a
        sum-reduced or masked loss adds, its gradients undivided, and
        the (batch-size-free) auxiliary losses are scaled by 1/k so they
        count once.  Returns (loss, sums, grads, updates)."""
        accum = int(self.config.gradient_accumulation_steps)
        mb = batch[0].shape[0] // accum
        summed = nvalid is not None or self._loss_reduction == "sum"
        aux_scale = 1.0 / accum if summed else 1.0
        acc: Optional[Dict[str, torch.Tensor]] = None
        losses_, sums_ = [], []
        updates: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            micro = tuple(a[i * mb:(i + 1) * mb] for a in batch)
            loss, sums, grads, updates, _ = self._loss_and_grads(
                micro, fold_seed(seed, i), nvalid=nvalid, base=i * mb,
                aux_scale=aux_scale)
            acc = grads if acc is None else {k: acc[k] + g
                                             for k, g in grads.items()}
            losses_.append(loss)
            sums_.append(sums)
        sums = {k: torch.stack([s[k] for s in sums_]).sum(
            dim=0, dtype=sums_[0][k].dtype) for k in sums_[0]}
        ls = torch.stack(losses_)
        if summed:
            return ls.sum(), sums, acc, updates
        return ls.mean(), sums, {k: g / accum for k, g in acc.items()}, \
            updates

    def _whole_rows(self, logits: torch.Tensor) -> torch.Tensor:
        """On a mesh, the loss's input with its class dim gathered (the
        batch and sequence dims stay split): the losses and metrics
        reduce over whole rows."""
        if not is_dtensor(logits):
            return logits
        return redistribute(logits, keep_shards(
            logits.placements, range(logits.dim() - 1)))

    def _surface_runtime_fallbacks(self) -> None:
        """Drain this model's replicate-fallback records (FF106) after a
        dispatch, as the JAX package's ``_surface_runtime_fallbacks``:
        the sites join ``runtime_fallback_sites`` and ``verify_report``
        and one aggregate line is logged.  A no-op when nothing fell
        back."""
        from .analysis.verifier import (drain_fallback_sites,
                                        fallback_site_diagnostics,
                                        has_fallback_records)
        if not has_fallback_records():
            return
        owned = {t.name for op in self.layers for t in op.outputs}
        owned.update(w.name for op in self.layers for w in op.weights)
        sites, dropped = drain_fallback_sites(owned_names=owned)
        if not sites and not dropped:
            return
        self.runtime_fallback_sites.update(sites)
        diags = fallback_site_diagnostics(sites, dropped, code="FF106")
        if self.verify_report is not None:
            self.verify_report.extend(diags)
        from .fflogger import get_logger
        get_logger("sharding").warning(
            f"{sum(d.count for d in diags)} replicate fallback(s) across "
            f"{len(diags)} site(s) [FF106]: the executor replicated "
            f"requested splits; see model.verify_report")

    def _apply_update(self, grads: Dict[str, torch.Tensor]) -> None:
        # host-placed parameters visit the device for the update
        trainable = {k: self._on_device(k, self._params[k]) for k in grads}
        grads = {k: self._on_device(k, g) for k, g in grads.items()}
        new, self._opt_state = self.optimizer.update(trainable, grads,
                                                     self._opt_state)
        self._store(new)
        self._step += 1

    @torch.no_grad()
    def _apply_sparse_update(self, batch,
                             row_grads: Dict[str, torch.Tensor]) -> None:
        """Plain SGD on the looked-up rows alone: ``table[id] -= lr *
        grad`` for every id of the batch, duplicates summed, in place
        (the rest of the table is neither read nor written), where the
        table lives: on the device, or for a host-placed table on the
        host, its ids and row gradients brought there.  Ids map by
        ``map_ids``, as the dense path's gradient does: negatives wrap,
        ids outside the table are dropped.  A dropped lane adds -0.0,
        which leaves every value's bits as they were."""
        for op_name, tname, pos in self._sparse_specs + self._host_rows:
            lr = self.optimizer.lr
            table = self._params[tname]
            idx, valid = map_ids(batch[pos].reshape(-1).to(table.device),
                                 table.shape[0])
            g = row_grads[op_name].reshape(idx.shape[0], -1).to(
                table.device)
            g = torch.where(valid[:, None], g, 0.0)
            table.index_add_(0, idx, (-lr * g).to(table.dtype))

    def _train_step(self, batch, nvalid: Optional[int] = None):
        """One optimizer step on ``batch`` (device tensors, labels
        last); ``nvalid`` selects the masked padded-tail step.  Returns
        (loss, metric sums) on the device."""
        if self._opt_state is None:
            raise RuntimeError("call compile() and init_layers() first")
        seed = self._step_seed(self._step)
        if self.config.gradient_accumulation_steps > 1:
            loss, sums, grads, updates = self._accumulate(batch, seed,
                                                          nvalid)
        else:
            loss, sums, grads, updates, row_grads = self._loss_and_grads(
                batch, seed, sparse=True, nvalid=nvalid)
            self._apply_sparse_update(batch, row_grads)
        self._apply_update(grads)
        # after the optimizer's step, as the JAX step returns
        # {**frozen, **updates, **new_trainable}
        self._store(updates)
        self._surface_runtime_fallbacks()
        return loss, sums

    def train_batch(self, *arrays) -> torch.Tensor:
        """One training step on one batch (the inputs, then the labels;
        numpy arrays or tensors).  Returns the loss as a 0-d device
        tensor, not fetched."""
        self._check_not_quantized("train_batch")
        if arrays:
            self._check_accum_divisible(len(arrays[0]), "batch of")
        loss, sums = self._train_step(self._device_batch(arrays))
        self._last_metric_sums = sums
        self._window_faults(self._step - 1, self._step)
        return loss

    def _run_window(self, window, nvalid=None) -> tuple:
        """The steps of a window of device tensors, back to back: lists
        of the per-step losses and metric-sum dicts, on the device."""
        losses_, sums_ = [], []
        for i in range(int(window[0].shape[0])):
            nv = None if nvalid is None else int(nvalid[i])
            loss, sums = self._train_step(tuple(a[i] for a in window), nv)
            losses_.append(loss)
            sums_.append(sums)
        return losses_, sums_

    def train_window(self, window, nvalid=None):
        """K training steps back to back (``FFConfig.steps_per_dispatch``),
        the counterpart of the JAX package's fused window: ``window`` is
        a tuple of stacked ``(K, batch...)`` arrays (host or device), the
        inputs then the labels; ``nvalid`` (K ints) selects the masked
        padded-tail step.  Nothing is fetched to the host, and the
        results are those of K ``train_batch`` calls on the K batches.
        Returns the device-resident ``(losses, metric_sums)``, stacked
        per step."""
        self._check_not_quantized("train_window")
        if self._opt_state is None:
            raise RuntimeError("call compile() and init_layers() first")
        self._check_accum_divisible(int(window[0].shape[1]),
                                    "window batch of")
        start = self._step
        losses_, sums_ = self._run_window(self._device_batch(window),
                                          nvalid)
        sums = {k: torch.stack([s[k] for s in sums_]) for k in sums_[0]}
        self._last_metric_sums = sums
        self._window_faults(start, self._step)
        return torch.stack(losses_), sums

    # the reference's imperative loop: set_batch, forward,
    # zero_gradients, backward, update
    def set_batch(self, *arrays) -> None:
        self._batch = self._device_batch(arrays)

    def forward(self) -> torch.Tensor:
        """The inference forward on the batch of ``set_batch``."""
        if self._batch is None:
            raise RuntimeError("set_batch() first")
        with torch.no_grad():
            return self._forward(self._params, self._batch[:-1])

    def zero_gradients(self) -> None:
        self._cached_grads = None

    def backward(self) -> torch.Tensor:
        """Loss and gradients on the batch of ``set_batch``; applies the
        ops' non-trainable state updates at once (as the JAX package's
        ``backward`` does; ``update`` leaves them alone), folds the
        batch's metrics into ``perf_metrics`` and returns the loss."""
        if self._batch is None:
            raise RuntimeError("set_batch() first")
        # dense and unaccumulated, as the JAX package's imperative loop is
        loss, sums, self._cached_grads, updates, _ = self._loss_and_grads(
            self._batch, self._step_seed(self._step))
        self._store(updates)
        self.perf_metrics.update(sums)
        return loss

    def update(self) -> None:
        if self._cached_grads is None:
            raise RuntimeError("backward() first")
        self._apply_update(self._cached_grads)
        self._cached_grads = None

    @staticmethod
    def _fetch(losses_, sums) -> tuple:
        """One device-to-host copy of a loop's per-step losses and
        metric-sum dicts: (float32 losses, list of host dicts)."""
        if not losses_:
            return np.zeros((0,), np.float32), []
        keys = list(sums[0])
        packed = torch.stack([
            torch.stack([loss.to(torch.float64)]
                        + [s[k].to(torch.float64) for k in keys])
            for loss, s in zip(losses_, sums)]).cpu().numpy()
        host = [{k: row[1 + i] for i, k in enumerate(keys)}
                for row in packed]
        return packed[:, 0].astype(np.float32), host

    def fit(self, x, y, epochs: Optional[int] = None,
            batch_size: Optional[int] = None, callbacks=None,
            verbose: bool = True, validation_data=None, pad_tail=None):
        """The epoch loop.  Per-step losses and metric sums stay on the
        device until one fetch per epoch; the last epoch's losses are
        kept on ``last_epoch_losses`` and its metrics on
        ``perf_metrics``.  Prints the ``epoch N:`` line and the
        reference's ``ELAPSED TIME = ..., THROUGHPUT = ... samples/s``
        line (training time only; validation is excluded; the samples
        actually trained, a padded tail's valid rows included).

        The epoch runs as windows of ``config.steps_per_dispatch=K``
        steps (one step a window by default), each window's upload
        issued before the previous window is handed out; in eager torch
        a window is its K steps back to back, so K changes which batches
        are resident on the device (two windows), not the steps.
        ``pad_tail`` (default: ``config.pad_tail_batches``) trains the
        tail samples that do not fill a batch through the masked padded
        step instead of dropping them.
        ``validation_data=(x_val, y_val)`` runs ``evaluate`` after every
        epoch.  The ``FF_FAULT`` training hooks fire after every window
        (kill, hang, slow rank, then the grow/shrink reshards).
        ``config.profiling`` prints ``profiling.profile_model``'s per-op
        table first.  Every epoch emits the ``ff`` logger's ``epoch``
        event (the JAX package's fields: ``epoch``, ``step``,
        ``samples``, ``elapsed_s``, ``steps_per_dispatch``,
        ``dispatches``, ``dispatch_ms`` — the mean host wall time around
        one window's dispatch, which in eager CUDA is its enqueue unless
        the queue is full — and the epoch's metric and validation
        scalars) and feeds the metrics registry's ``ff_train_*``
        counters and gauge.  Span tracing comes with the tooling slice
        (ROADMAP A.11)."""
        self._check_not_quantized("fit")
        cfg = self.config
        epochs = epochs or cfg.epochs
        bs = batch_size or cfg.batch_size
        self._check_accum_divisible(bs, "fit batch_size")
        k = max(1, int(cfg.steps_per_dispatch))
        pad = cfg.pad_tail_batches if pad_tail is None else bool(pad_tail)
        if validation_data is not None and (
                not isinstance(validation_data, (tuple, list))
                or len(validation_data) != 2):
            raise ValueError("validation_data must be a (x_val, y_val) pair")
        xs = x if isinstance(x, (list, tuple)) else [x]
        callbacks = callbacks or []
        for cb in callbacks:
            cb.set_model(self)
            cb.on_train_begin()
        if cfg.profiling:
            # the reference's per-op fwd/bwd table, each op timed alone
            # on the model's device
            from .profiling import profile_model
            profile_model(self)
        loader = PrefetchLoader(self, xs, y, batch_size=bs,
                                steps_per_dispatch=k, pad_tail=pad)
        t_start = time.time()
        t_fit = _perf_counter()
        total_samples = 0
        val_time = 0.0
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            self.perf_metrics = metrics_mod.PerfMetrics()
            epoch_losses, epoch_sums = [], []
            dispatches, dispatch_time = 0, 0.0
            epoch_step0 = self._step
            for window, nvalid in loader.iter_windows():
                start = self._step
                t_d = _perf_counter()
                losses_, sums_ = self._run_window(window, nvalid)
                dispatch_time += _perf_counter() - t_d
                dispatches += 1
                self._window_faults(start, self._step)
                epoch_losses.extend(losses_)
                epoch_sums.extend(sums_)
            total_samples += loader.num_samples_used
            self.last_epoch_losses, host_sums = self._fetch(epoch_losses,
                                                            epoch_sums)
            for sums in host_sums:
                self.perf_metrics.update(sums)
            val_scalars: Dict[str, float] = {}
            if validation_data is not None:
                t_val = time.time()
                val_loss, val_pm = self.evaluate(*validation_data,
                                                 batch_size=bs)
                val_time += time.time() - t_val
                val_scalars = {"val_loss": float(val_loss)}
                val_scalars.update({f"val_{k}": float(v)
                                    for k, v in val_pm.scalars().items()
                                    if k != "samples_seen"})
                self.perf_metrics.val_scalars = val_scalars
            self._epoch_record(epoch, epoch_step0, total_samples, t_fit,
                               k, dispatches, dispatch_time,
                               loader.num_samples_used, val_scalars)
            for cb in callbacks:
                cb.on_epoch_end(epoch, self.perf_metrics)
            stopping = any(getattr(cb, "stop_training", False)
                           for cb in callbacks)
            if verbose and (epoch % cfg.print_frequency == 0
                            or epoch == epochs - 1 or stopping):
                line = (f"epoch {epoch}: " + self.perf_metrics.report(
                    self.metrics or [self.loss_type]))
                if val_scalars:
                    line += " — " + ", ".join(
                        f"{k}: {v:.6g}" for k, v in val_scalars.items())
                print(line)
            if stopping:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.time() - t_start
        train_elapsed = max(1e-9, elapsed - val_time)
        if verbose and elapsed > 0:
            print(f"ELAPSED TIME = {train_elapsed:.4f}s, "
                  f"THROUGHPUT = {total_samples / train_elapsed:.2f} "
                  f"samples/s")
        for cb in callbacks:
            cb.on_train_end()
        return self.perf_metrics

    def _epoch_record(self, epoch: int, epoch_step0: int,
                      total_samples: int, t_fit: float, k: int,
                      dispatches: int, dispatch_time: float,
                      epoch_samples: int, val_scalars: Dict) -> None:
        """One epoch's train-loop numbers into the process metrics
        registry and the ``ff`` logger's ``epoch`` event, as the JAX
        package's ``fit`` records them: a ``/metrics`` scrape and the
        event report the same numbers.  ``elapsed_s`` counts from
        ``t_fit``, a ``perf_counter`` reading at ``fit``'s start."""
        from .fflogger import get_logger
        from .obs.registry import get_registry
        dispatch_ms = dispatch_time / max(1, dispatches) * 1e3
        reg = get_registry()
        reg.counter("ff_train_steps_total",
                    "Optimizer steps executed").labels().inc(
            self._step - epoch_step0)
        reg.counter("ff_train_dispatches_total",
                    "Training dispatches (fused windows count "
                    "once)").labels().inc(dispatches)
        reg.counter("ff_train_samples_total",
                    "Training samples consumed").labels().inc(epoch_samples)
        reg.gauge("ff_train_dispatch_ms",
                  "Mean wall ms per training dispatch, last "
                  "epoch").labels().set(dispatch_ms)
        get_logger("ff").event(
            "epoch", epoch=epoch, step=self._step, samples=total_samples,
            elapsed_s=round(_perf_counter() - t_fit, 3),
            steps_per_dispatch=k, dispatches=dispatches,
            dispatch_ms=round(dispatch_ms, 3),
            **{mk: round(float(v), 6)
               for mk, v in {**self.perf_metrics.scalars(),
                             **val_scalars}.items()})

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        """Batched evaluation over every sample: the last batch is
        zero-padded and masked, so only real rows count.  Per-batch
        loss and metric sums stay on the device until one fetch at the
        end.  Returns (loss, PerfMetrics)."""
        self._check_not_quantized("evaluate")
        if not self._compiled:
            raise RuntimeError("call compile() first")
        bs = batch_size or self.config.batch_size
        xs = x if isinstance(x, (list, tuple)) else [x]
        n = xs[0].shape[0]
        pm = metrics_mod.PerfMetrics()
        loss_sums, all_sums = [], []
        with torch.no_grad(), _mesh_context(self._on_mesh):
            for it in range(-(-n // bs)):
                lo, hi = it * bs, min(n, (it + 1) * bs)
                batch = upload(self._pad_tail(
                    tuple(a[lo:hi] for a in xs) + (y[lo:hi],), bs),
                    self.device)
                logits = self._whole_rows(self._forward_values(
                    self._params, batch[:-1])[self._loss_tensor.uid])
                labels = batch[-1]
                mask = (torch.arange(bs, device=self.device)
                        < hi - lo).to(torch.float32)
                loss_sums.append(gather(torch.sum(
                    self._per_example_loss(logits, labels) * mask)))
                all_sums.append({k: gather(v) for k, v in
                                 metrics_mod.compute_batch_metrics(
                                     logits, labels, self.metrics,
                                     self.loss_type, nvalid=hi - lo).items()})
        self._surface_runtime_fallbacks()
        host_losses, host_sums = self._fetch(loss_sums, all_sums)
        for sums in host_sums:
            pm.update(sums)
        denom = max(1, n) if self._loss_reduction == "mean" else 1
        return float(host_losses.astype(np.float64).sum()) / denom, pm
