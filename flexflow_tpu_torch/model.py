"""FFModel — graph builder, single-device compile and inference verbs.

Counterpart of ``flexflow_tpu/model.py`` for the serving path: the
builder methods append Ops to a layer list with the JAX package's
naming (so parameter names match one for one), ``compile()`` resolves
the single-device plan, ``init_layers`` creates the parameters on the
model's device, and ``forward_compiled``/``predict`` run the forward
eagerly under ``torch.inference_mode()``.

The model runs on CUDA unless the caller passes another device
(``device="cpu"`` in the tests); without CUDA and without a device it
raises instead of falling back.  Strategy import and search, meshes and
the training verbs come in later slices, and ``compile`` refuses what
it cannot honour.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import losses
from .config import FFConfig
from .initializers import GlorotUniform
from .op import Op, OpContext, OpType, resolve_conv_layout
from .ops.common import resolve_op_dtype, torch_dtype
from .ops.conv import Conv2D, Pool2D
from .ops.linear import Linear
from .ops.tensor_ops import Flat, Softmax
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


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None,
                 device=None):
        self.config = config if config is not None else FFConfig()
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

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def compile(self, optimizer=None, loss_type: Optional[str] = None,
                metrics: Optional[Sequence[str]] = None,
                comp_mode: str = "training", mesh=None,
                final_tensor: Optional[Tensor] = None) -> None:
        """Resolve the single-device plan: loss tensor, label tensor and
        conv layout.  ``optimizer`` and ``loss_type`` are stored for the
        training verbs.  Raises NotImplementedError for what the port
        cannot run yet — an imported or searched strategy, or more than
        one device — rather than silently ignoring it."""
        cfg = self.config
        if cfg.import_strategy_file or cfg.search_budget > 0 \
                or cfg.strategies:
            raise NotImplementedError(
                "imported or searched parallelization strategies are not "
                "ported yet; the port runs the default single-device plan")
        n_dev = 1
        for v in (cfg.mesh_shape or {}).values():
            n_dev *= int(v)
        if mesh is not None or cfg.num_devices > 1 or n_dev > 1:
            raise NotImplementedError(
                "distributed meshes are not ported yet; the port runs on "
                "one device")
        if not self.layers:
            raise ValueError("compile() needs at least one layer")
        self.optimizer = optimizer or self.optimizer
        if loss_type is not None:
            self.loss_type = loss_type
        if self.loss_type is None:
            self.loss_type = losses.SPARSE_CATEGORICAL_CROSSENTROPY
        self.metrics = list(metrics or self.metrics or [])
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
        self._fwd_compiled = {}
        self._compiled = True

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init_layers(self, seed: Optional[int] = None) -> None:
        """Create every parameter on the model's device from ``seed``
        (default ``config.seed``)."""
        if not self._compiled:
            raise RuntimeError("call compile() first")
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator().manual_seed(int(seed))
        params: Dict[str, torch.Tensor] = {}
        for p in self.parameters:
            init = p.initializer or GlorotUniform()
            dtype = torch_dtype(self.config.param_dtype
                                if p.dtype == "float32" else p.dtype)
            params[p.name] = init(gen, p.shape, dtype).to(self.device)
        self._params = params

    def _resolve(self, name: str) -> str:
        if name in self._params:
            return name
        for k in self._params:
            if k.endswith("/" + name) or k.split("/")[0] == name:
                return k
        raise KeyError(name)

    def get_weights(self, name: str) -> np.ndarray:
        return to_host(self._params[self._resolve(name)])

    def set_weights(self, name: str, value) -> None:
        key = self._resolve(name)
        cur = self._params[key]
        arr = np.asarray(value)
        if arr.dtype.kind not in "biuf":  # e.g. ml_dtypes bfloat16
            arr = arr.astype(np.float32)
        val = torch.tensor(arr)  # a copy: the caller keeps its array
        self._params[key] = val.to(device=cur.device,
                                   dtype=cur.dtype).reshape(cur.shape)

    @property
    def num_parameters(self) -> int:
        return sum(p.volume for p in self.parameters)

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def _forward(self, params: Dict[str, torch.Tensor],
                 inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Run the layer list on ``inputs`` and return the final tensor.
        Each op runs in its resolved compute dtype."""
        base = self.config.compute_dtype
        ctx = OpContext(device=self.device, training=False,
                        compute_dtype=base,
                        conv_layout=self.resolved_conv_layout)
        values = {t.uid: v for t, v in zip(self.input_tensors, inputs)}
        for op in self.layers:
            ctx.compute_dtype = resolve_op_dtype(op, base)
            outs = op.forward(params, [values[t.uid] for t in op.inputs],
                              ctx)
            for t, v in zip(op.outputs, outs):
                values[t.uid] = v
        return values[self._final_tensor.uid]

    def forward_compiled(self, bucket_bs: int) -> Callable:
        """The inference forward for batches of exactly ``bucket_bs``
        rows, cached per bucket.  Call as ``fwd(model._params, batch)``
        with ``batch`` a tuple of input tensors on the model's device;
        it runs under ``torch.inference_mode()`` and returns the output
        tensor on the device.  The serving engine warms one per shape
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
                with torch.inference_mode():
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
        return to_host(torch.cat(outs, dim=0))
