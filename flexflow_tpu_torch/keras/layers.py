"""Keras-compatible layers, the port of ``flexflow_tpu/keras/layers.py``
(reference ``python/flexflow/keras/layers/``: core.py, convolutional.py,
pool.py, merge.py, normalization.py, input_layer.py).

Each layer is a deferred graph node: ``__call__`` records connectivity on
:class:`KerasTensor` handles, and ``build_ff`` emits the corresponding
FFModel op at ``Model.compile`` time — the same two-phase design as the
reference (keras layers collect, ``_create_flexflow_layers`` emits,
base_model.py:129-192).  Shapes are channels-first (n,c,h,w), matching
the reference's cuDNN tensors; on a CUDA device the conv and pool ops
keep that shape over channels-last memory (``conv_layout="auto"``), so
:class:`MaxPooling2D` runs the hand-written max-pool kernels and
:class:`LayerNormalization` the fused LayerNorm kernel.

Default layer names come from a per-class counter (``dense_1``,
``dense_2``, ...), so two graphs built in one process name their layers
by build order, as the JAX package's do.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


class KerasTensor:
    """Symbolic tensor: shape EXCLUDES the batch dim (keras convention).
    ``inbound`` records the inputs of the call that produced it, so a layer
    called more than once (shared weights) yields one graph node per call."""

    def __init__(self, shape: Tuple[int, ...], dtype: str = "float32",
                 producer: Optional["Layer"] = None, index: int = 0,
                 inbound: Optional[List["KerasTensor"]] = None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.producer = producer
        self.index = index
        self.inbound: List["KerasTensor"] = list(inbound or [])

    def __repr__(self):
        return f"KerasTensor(shape={self.shape}, dtype={self.dtype})"


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


class Layer:
    _uid = 0

    def __init__(self, name: Optional[str] = None):
        type(self)._uid += 1
        self.name = name or f"{type(self).__name__.lower()}_{type(self)._uid}"
        self.inbound: List[KerasTensor] = []
        self.input_shape: Optional[Tuple[int, ...]] = None

    # --- graph recording -------------------------------------------------
    def __call__(self, inputs):
        ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        out_shapes = self.compute_output_shape([t.shape for t in ins])
        out = KerasTensor(out_shapes, self.output_dtype(ins), self,
                          inbound=ins)
        if not self.inbound:  # first call: keep legacy attributes
            self.inbound = ins
            self.output = out
        return out

    def output_dtype(self, ins: List[KerasTensor]) -> str:
        return ins[0].dtype

    def compute_output_shape(self, in_shapes) -> Tuple[int, ...]:
        return tuple(in_shapes[0])

    # --- FFModel emission ------------------------------------------------
    def build_ff(self, ff, in_tensors):
        raise NotImplementedError

    def get_weights(self, ffmodel=None):
        model = ffmodel or self._core_model
        out = []
        for suffix in self._weight_names():
            out.append(model.get_weights(f"{self.name}/{suffix}"))
        return out

    def set_weights(self, weights, ffmodel=None):
        model = ffmodel or self._core_model
        for suffix, w in zip(self._weight_names(), weights):
            model.set_weights(f"{self.name}/{suffix}", w)

    def _weight_names(self):
        return ()


class InputLayer(Layer):
    def __init__(self, shape=None, dtype="float32", name=None,
                 input_shape=None):
        super().__init__(name)
        self.shape = tuple(shape if shape is not None else input_shape)
        self.dtype = dtype
        self.output = KerasTensor(self.shape, dtype, self)


def Input(shape, dtype="float32", name=None) -> KerasTensor:
    return InputLayer(shape=shape, dtype=dtype, name=name).output


class Dense(Layer):
    def __init__(self, units, activation=None, use_bias=True,
                 kernel_initializer=None, bias_initializer=None,
                 input_shape=None, name=None):
        super().__init__(name)
        self.units = int(units)
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.input_shape = tuple(input_shape) if input_shape else None

    def compute_output_shape(self, in_shapes):
        return tuple(in_shapes[0][:-1]) + (self.units,)

    def build_ff(self, ff, in_tensors):
        return ff.dense(in_tensors[0], self.units, activation=self.activation,
                        use_bias=self.use_bias,
                        kernel_initializer=self.kernel_initializer,
                        bias_initializer=self.bias_initializer,
                        name=self.name)

    def _weight_names(self):
        return ("kernel", "bias") if self.use_bias else ("kernel",)


class Conv2D(Layer):
    """channels_first: input (C, H, W) per sample."""

    def __init__(self, filters, kernel_size, strides=(1, 1), padding="valid",
                 activation=None, use_bias=True, groups=1,
                 kernel_initializer=None, bias_initializer=None,
                 input_shape=None, name=None):
        super().__init__(name)
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.activation = activation
        self.use_bias = use_bias
        self.groups = groups
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.input_shape = tuple(input_shape) if input_shape else None

    def _pad(self) -> Tuple[int, int]:
        if isinstance(self.padding, (tuple, list)):
            return _pair(self.padding)
        if self.padding == "same":
            return self.kernel_size[0] // 2, self.kernel_size[1] // 2
        return 0, 0

    def compute_output_shape(self, in_shapes):
        c, h, w = in_shapes[0]
        kh, kw = self.kernel_size
        sh, sw = self.strides
        ph, pw = self._pad()
        return (self.filters, (h + 2 * ph - kh) // sh + 1,
                (w + 2 * pw - kw) // sw + 1)

    def build_ff(self, ff, in_tensors):
        ph, pw = self._pad()
        return ff.conv2d(in_tensors[0], self.filters, *self.kernel_size,
                         *self.strides, ph, pw, activation=self.activation,
                         groups=self.groups, use_bias=self.use_bias,
                         kernel_initializer=self.kernel_initializer,
                         bias_initializer=self.bias_initializer,
                         name=self.name)

    def _weight_names(self):
        return ("kernel", "bias") if self.use_bias else ("kernel",)


class _Pool2D(Layer):
    pool_type = "max"

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name=None):
        super().__init__(name)
        self.pool_size = _pair(pool_size)
        self.strides = (_pair(strides) if strides is not None
                        else self.pool_size)
        self.padding = padding

    def _pad(self):
        if isinstance(self.padding, (tuple, list)):
            return _pair(self.padding)
        if self.padding == "same":
            return self.pool_size[0] // 2, self.pool_size[1] // 2
        return 0, 0

    def compute_output_shape(self, in_shapes):
        c, h, w = in_shapes[0]
        kh, kw = self.pool_size
        sh, sw = self.strides
        ph, pw = self._pad()
        return (c, (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1)

    def build_ff(self, ff, in_tensors):
        ph, pw = self._pad()
        return ff.pool2d(in_tensors[0], *self.pool_size, *self.strides,
                         ph, pw, pool_type=self.pool_type, name=self.name)


class MaxPooling2D(_Pool2D):
    pool_type = "max"


class AveragePooling2D(_Pool2D):
    pool_type = "avg"


class Flatten(Layer):
    def __init__(self, name=None, input_shape=None):
        super().__init__(name)
        self.input_shape = tuple(input_shape) if input_shape else None

    def compute_output_shape(self, in_shapes):
        n = 1
        for d in in_shapes[0]:
            n *= d
        return (n,)

    def build_ff(self, ff, in_tensors):
        return ff.flat(in_tensors[0], name=self.name)


class Activation(Layer):
    def __init__(self, activation, name=None):
        super().__init__(name)
        self.activation = activation

    def build_ff(self, ff, in_tensors):
        if self.activation == "softmax":
            return ff.softmax(in_tensors[0], name=self.name)
        return ff._unary(self.activation, in_tensors[0], name=self.name)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__(name)
        self.axis = axis

    def build_ff(self, ff, in_tensors):
        return ff.softmax(in_tensors[0], axis=self.axis, name=self.name)


class Dropout(Layer):
    def __init__(self, rate, seed=0, name=None):
        super().__init__(name)
        self.rate, self.seed = rate, seed

    def build_ff(self, ff, in_tensors):
        return ff.dropout(in_tensors[0], self.rate, self.seed, name=self.name)


class Embedding(Layer):
    def __init__(self, input_dim, output_dim, input_length=None,
                 embeddings_initializer=None, name=None):
        super().__init__(name)
        self.input_dim, self.output_dim = int(input_dim), int(output_dim)
        self.input_length = input_length
        self.embeddings_initializer = embeddings_initializer

    def output_dtype(self, ins):
        return "float32"

    def compute_output_shape(self, in_shapes):
        return tuple(in_shapes[0]) + (self.output_dim,)

    def build_ff(self, ff, in_tensors):
        return ff.embedding(in_tensors[0], self.input_dim, self.output_dim,
                            aggr="none",
                            kernel_initializer=self.embeddings_initializer,
                            name=self.name)

    def _weight_names(self):
        return ("table",)


class BatchNormalization(Layer):
    def __init__(self, momentum=0.9, epsilon=1e-5, relu=False, name=None):
        super().__init__(name)
        self.momentum, self.epsilon, self.relu = momentum, epsilon, relu

    def build_ff(self, ff, in_tensors):
        return ff.batch_norm(in_tensors[0], relu=self.relu,
                             momentum=self.momentum, eps=self.epsilon,
                             name=self.name)

    def _weight_names(self):
        return ("scale", "bias")


class LayerNormalization(Layer):
    def __init__(self, epsilon=1e-5, name=None):
        super().__init__(name)
        self.epsilon = epsilon

    def build_ff(self, ff, in_tensors):
        return ff.layer_norm(in_tensors[0], eps=self.epsilon, name=self.name)


class Concatenate(Layer):
    def __init__(self, axis=1, name=None):
        super().__init__(name)
        self.axis = axis  # keras axis counts the batch dim; 1 == features

    def compute_output_shape(self, in_shapes):
        ax = self.axis - 1 if self.axis > 0 else len(in_shapes[0]) + self.axis
        out = list(in_shapes[0])
        out[ax] = sum(s[ax] for s in in_shapes)
        return tuple(out)

    def build_ff(self, ff, in_tensors):
        return ff.concat(in_tensors, axis=self.axis, name=self.name)


class _Merge(Layer):
    fn = "add"

    def build_ff(self, ff, in_tensors):
        return ff._binary(self.fn, in_tensors[0], in_tensors[1],
                          name=self.name)


class Add(_Merge):
    fn = "add"


class Subtract(_Merge):
    fn = "sub"


class Multiply(_Merge):
    fn = "mul"
