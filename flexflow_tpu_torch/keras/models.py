"""Keras-compatible Sequential / functional Model, the port of
``flexflow_tpu/keras/models.py`` (reference
``python/flexflow/keras/models/{base_model,sequential,model}.py``).

``compile`` builds the core FFModel from the recorded layer graph and
delegates to ``FFModel.compile`` (the reference's
``_create_flexflow_layers`` + ``_ffmodel.compile``, base_model.py:129-192);
``fit``/``evaluate``/``predict`` drive the training verbs with the
reference's callback protocol (``_train``, base_model.py:194-251).  The
model runs on the card unless the process has another default device
(``config.set_default_device``, the runner's ``--device``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .. import losses as core_losses
from .. import metrics as core_metrics
from ..config import FFConfig, get_default_config
from ..model import FFModel
from .layers import InputLayer, KerasTensor, Layer
from .optimizers import to_core_optimizer

_LOSS_MAP = {
    "categorical_crossentropy": core_losses.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        core_losses.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": core_losses.MEAN_SQUARED_ERROR,
    "mse": core_losses.MEAN_SQUARED_ERROR,
}

# metric spellings (incl. keras aliases) are canonicalized by the core:
# metrics.canonicalize_metrics — one table, not two


class BaseModel:
    def __init__(self, name: Optional[str] = None):
        self.name = name
        self.ffmodel: Optional[FFModel] = None
        self.ffconfig: Optional[FFConfig] = None
        self._compiled = False

    # ---- graph -> FFModel ----------------------------------------------
    def _topo_tensors(self, outputs: List[KerasTensor]) -> List[KerasTensor]:
        """Per-call tensor nodes in topological order (a layer called N
        times contributes N nodes — shared-layer reuse)."""
        order: List[KerasTensor] = []
        seen: set = set()

        def visit(t: KerasTensor):
            if id(t) in seen:
                return
            seen.add(id(t))
            for src in t.inbound:
                visit(src)
            order.append(t)

        for t in outputs:
            visit(t)
        return order

    def _topo_layers(self, outputs: List[KerasTensor]) -> List[Layer]:
        seen: List[Layer] = []
        for t in self._topo_tensors(outputs):
            if t.producer is not None and t.producer not in seen:
                seen.append(t.producer)
        return seen

    def _build_ff(self, inputs: List[KerasTensor],
                  outputs: List[KerasTensor], config: FFConfig) -> None:
        ff = FFModel(config)
        values: Dict[int, object] = {}
        for kt in inputs:
            layer = kt.producer
            assert isinstance(layer, InputLayer), \
                "functional graphs must start at Input()"
            values[id(kt)] = ff.create_tensor(
                (config.batch_size,) + kt.shape, dtype=kt.dtype,
                name=layer.name)
        # layer -> (first core op, #calls emitted): later calls of the same
        # layer emit a fresh op whose weights alias the first call's
        # (reference keras graph model shares one weight region per layer)
        emitted: Dict[Layer, list] = {}
        for kt in self._topo_tensors(outputs):
            layer = kt.producer
            if layer is None or isinstance(layer, InputLayer) \
                    or id(kt) in values:
                continue
            in_ts = [values[id(t)] for t in kt.inbound]
            if layer in emitted:
                first_op, calls = emitted[layer]
                orig = layer.name
                layer.name = f"{orig}__shared{calls}"
                try:
                    out = layer.build_ff(ff, in_ts)
                finally:
                    layer.name = orig
                ff.share_weights(out.owner_op, first_op)
                emitted[layer][1] += 1
            else:
                out = layer.build_ff(ff, in_ts)
                emitted[layer] = [out.owner_op, 1]
            values[id(kt)] = out
            layer._core_model = ff
        self.ffmodel = ff
        self._ff_outputs = [values[id(t)] for t in outputs]

    # ---- keras API ------------------------------------------------------
    def compile(self, optimizer, loss=None, metrics=None, config=None,
                mesh=None, **kwargs):
        """Build the FFModel graph, compile it and initialise its
        parameters from ``config.seed``.  ``config`` defaults to the
        process default (the runner's flags); the model runs on the
        process's default device, else the card, which must then be
        present."""
        for k in ("loss_weights", "weighted_metrics", "run_eagerly"):
            assert kwargs.pop(k, None) is None, f"{k} is not supported"
        assert loss is not None, "loss is None"
        loss_type = (_LOSS_MAP.get(loss, loss) if isinstance(loss, str)
                     else loss)
        for m in metrics or []:
            assert isinstance(m, str), f"unsupported metric {m!r}"
        metric_types = core_metrics.canonicalize_metrics(metrics or [])
        if config is None:
            # pick up the flexflow-tpu-torch runner's parsed flags (cli.py)
            config = get_default_config()
        self.ffconfig = config
        self._build_graph()  # subclass hook: sets self._inputs/_outputs
        self._build_ff(self._inputs, self._outputs, self.ffconfig)
        core_opt = to_core_optimizer(optimizer)
        self.optimizer = core_opt
        # fused softmax-CE parity: compile() resolves the softmax/logit
        # split itself (model.py)
        self.ffmodel.compile(core_opt, loss_type, metric_types, mesh=mesh,
                             final_tensor=self._ff_outputs[0])
        self.ffmodel.init_layers(seed=self.ffconfig.seed)
        self._compiled = True

    def fit(self, x=None, y=None, batch_size=None, epochs=1, verbose=1,
            callbacks=None, validation_data=None, validation_split=0.0,
            **kwargs):
        for k, dflt in (("class_weight", None), ("sample_weight", None),
                        ("initial_epoch", 0), ("steps_per_epoch", None)):
            assert kwargs.pop(k, dflt) == dflt, f"{k} is not supported"
        assert self._compiled, "compile() first"
        if validation_split and validation_data is None:
            if not 0.0 < float(validation_split) < 1.0:
                raise ValueError(
                    f"validation_split must be in (0, 1), got "
                    f"{validation_split!r}")
            # keras semantics: the LAST fraction of the data, un-shuffled
            xs = x if isinstance(x, (list, tuple)) else [x]
            n = xs[0].shape[0]
            cut = max(1, int(n * (1.0 - float(validation_split))))
            validation_data = ([a[cut:] for a in xs], y[cut:])
            x = [a[:cut] for a in xs] if isinstance(x, (list, tuple)) \
                else xs[0][:cut]
            y = y[:cut]
        return self.ffmodel.fit(x, y, epochs=epochs, batch_size=batch_size,
                                callbacks=callbacks, verbose=bool(verbose),
                                validation_data=validation_data)

    def save_weights(self, filepath):
        """Params-only .npz in graph order (keras save_weights
        analogue) — the full training state (optimizer slots + step) is
        ``ffmodel.save_checkpoint``.  Keys are ``<index>:<name>`` so a
        twin model whose auto-numbered layer names differ (keras names
        are session-global) still loads by position; the JAX package
        writes the same file.  Same write invariants as
        save_checkpoint: on a mesh every rank gathers the full values
        (a collective), rank 0 publishes atomically (tmp + rename), and
        the ranks meet at a barrier."""
        from ..parallel import distributed
        from ..resilience import _atomic_savez
        assert self._compiled, "compile() first"
        m = self.ffmodel
        # graph DECLARATION order (m.parameters), the JAX file's order
        flat = {f"{i}:{p.name}": m.get_weights(p.name)
                for i, p in enumerate(m.parameters)}
        final = m._ckpt_path(str(filepath))
        if distributed.process_info()["process_index"] == 0:
            _atomic_savez(final, flat)  # same tmp+rename as save_checkpoint
        distributed.coordination_barrier("ff_weights_written")

    def load_weights(self, filepath):
        """Restore by name when the names match, else by graph position
        (keras topological-order semantics); shape mismatches fail
        loudly before any state mutates."""
        import numpy as np
        assert self._compiled, "compile() first"
        m = self.ffmodel
        path = m._ckpt_path(str(filepath))
        with np.load(path) as f:
            stored = sorted(((int(k.split(":", 1)[0]), k.split(":", 1)[1],
                              k) for k in f.files))
            # declaration order on this side too (see save_weights)
            cur = [(p.name, tuple(p.shape)) for p in m.parameters]
            if len(stored) != len(cur):
                raise ValueError(
                    f"weights file has {len(stored)} params, model has "
                    f"{len(cur)}")
            by_name = {name: key for _, name, key in stored}
            names = [n for n, _ in cur]
            pairs = ([(n, by_name[n]) for n in names]
                     if set(by_name) == set(names)
                     else list(zip(names, (key for _, _, key in stored))))
            shapes = dict(cur)
            loaded = {}
            for name, key in pairs:
                val = np.asarray(f[key])
                if val.shape != shapes[name]:
                    raise ValueError(
                        f"{name}: weights shape {val.shape} != "
                        f"{shapes[name]}")
                loaded[name] = val
        for name, val in loaded.items():
            m.set_weights(name, val)

    def evaluate(self, x, y, batch_size=None):
        return self.ffmodel.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size=None):
        return self.ffmodel.predict(x, batch_size=batch_size)

    def summary(self) -> str:
        return self.ffmodel.summary() if self.ffmodel else type(self).__name__

    def get_layer(self, name=None, index=None) -> Layer:
        layers = self._layer_list()
        if name is not None:
            for l in layers:
                if l.name == name:
                    return l
            raise ValueError(f"no layer named {name!r}")
        return layers[index]

    @property
    def layers(self) -> List[Layer]:
        return [l for l in self._layer_list()
                if not isinstance(l, InputLayer)]

    def get_perf_metrics(self):
        return self.ffmodel.perf_metrics


class Model(BaseModel):
    """Functional model: ``Model(inputs, outputs)``."""

    def __init__(self, inputs, outputs, name=None):
        super().__init__(name)
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]

    def _build_graph(self):
        pass  # graph already recorded by layer calls

    def _layer_list(self):
        return self._topo_layers(self._outputs)

    def __call__(self, inputs):
        """Model-as-layer (reference func_cifar10_cnn_concat_model.py):
        replay this model's layer graph on new tensors.  The SAME layer
        objects are re-invoked, so every call site shares one weight set
        (the emitted-layer aliasing in ``_build_ff``)."""
        ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        assert len(ins) == len(self._inputs), \
            f"model expects {len(self._inputs)} inputs, got {len(ins)}"
        for t in ins:  # eager model(x) on arrays is not supported — the
            # deferred graph needs symbolic tensors (use predict())
            if not isinstance(t, KerasTensor):
                raise TypeError(
                    f"model-as-layer expects KerasTensor inputs, got "
                    f"{type(t).__name__}; use model.predict(x) for arrays")
        mapping = {id(kt): t for kt, t in zip(self._inputs, ins)}
        for kt in self._topo_tensors(self._outputs):
            if id(kt) in mapping:
                continue
            layer = kt.producer
            if layer is None or isinstance(layer, InputLayer):
                raise ValueError(
                    "model references an Input() not listed in its inputs")
            assert kt.index == 0, "multi-output layers can't be replayed"
            new_in = [mapping[id(t)] for t in kt.inbound]
            mapping[id(kt)] = layer(
                new_in if len(new_in) > 1 else new_in[0])
        outs = [mapping[id(t)] for t in self._outputs]
        return outs if len(outs) > 1 else outs[0]


class Sequential(BaseModel):
    def __init__(self, layers: Optional[Sequence[Layer]] = None, name=None):
        super().__init__(name)
        self._stack: List[Layer] = []
        for l in layers or []:
            self.add(l)

    def add(self, layer: Layer) -> None:
        self._stack.append(layer)

    def pop(self) -> None:
        self._stack.pop()

    def _build_graph(self):
        first = self._stack[0]
        if isinstance(first, KerasTensor):  # Sequential([Input(...), ...])
            first = first.producer
            self._stack[0] = first
        if isinstance(first, InputLayer):
            t = first.output
            stack = self._stack[1:]
        else:
            assert first.input_shape is not None, \
                "first layer needs input_shape="
            dtype = "int32" if type(first).__name__ == "Embedding" \
                else "float32"
            inp = InputLayer(shape=first.input_shape, dtype=dtype)
            t = inp.output
            stack = self._stack
        self._inputs = [t]
        for layer in stack:
            t = layer(t)
        self._outputs = [t]

    def _layer_list(self):
        return list(self._stack)

    def __call__(self, t):
        """Sequential-as-layer (reference
        func_cifar10_cnn_concat_seq_model.py): apply the stack to a new
        tensor; weights are shared across call sites."""
        if not isinstance(t, KerasTensor):
            raise TypeError(
                f"model-as-layer expects a KerasTensor input, got "
                f"{type(t).__name__}; use model.predict(x) for arrays")
        for layer in self._stack:
            if isinstance(layer, KerasTensor):
                layer = layer.producer
            if isinstance(layer, InputLayer):
                continue
            t = layer(t)
        return t
