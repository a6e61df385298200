"""torch.nn-style shim, the port of ``flexflow_tpu/torch/nn.py``
(reference ``python/flexflow/torch/nn/modules``): ``Module`` subclasses
declare layers as attributes and compose them in ``forward``; each layer
call appends the matching FFModel op, like the reference's
``Module.__setattr__`` + per-layer ``init_inout`` wiring
(modules/module.py) but with the graph built directly by ``forward``.

These are not ``torch.nn`` modules: a :class:`Module` here owns an
:class:`~flexflow_tpu_torch.model.FFModel` and its ``forward`` records
graph ops on symbolic tensors, which ``compile`` then runs on the card
(on a CUDA device :class:`MaxPool2d` runs the hand-written max-pool
kernels).  The package is named ``nn_compat``, not ``torch``, so that
inside a torch package it never reads as torch itself.

Usage (mirrors examples/python/native/alexnet_torch.py):

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, kernel_size=11, stride=4, padding=2)
            self.fc = nn.Linear(4096, 10)
        def forward(self, x):
            return self.fc(self.flat(self.conv1(x)))

    net = Net()
    logits = net(net.create_input((batch, 3, 229, 229)))
    net.compile(...); net.fit(x, y)
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..config import FFConfig, get_default_config
from ..model import FFModel


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


class _LayerModule:
    """A leaf layer; bound to the owning Module at attribute-set time."""

    _module: Optional["Module"] = None
    name: Optional[str] = None

    def _ff(self) -> FFModel:
        assert self._module is not None, \
            "layer must be assigned as a Module attribute before use"
        return self._module.ffmodel

    def __call__(self, x):
        return self.forward(x)


class Conv2d(_LayerModule):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, bias=True):
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.groups, self.bias = groups, bias

    def forward(self, x):
        return self._ff().conv2d(x, self.out_channels, *self.kernel_size,
                                 *self.stride, *self.padding,
                                 groups=self.groups, use_bias=self.bias,
                                 name=self.name)


class MaxPool2d(_LayerModule):
    def __init__(self, kernel_size, stride=None, padding=0):
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None else self.kernel_size
        self.padding = _pair(padding)

    def forward(self, x):
        return self._ff().pool2d(x, *self.kernel_size, *self.stride,
                                 *self.padding, pool_type="max",
                                 name=self.name)


class AvgPool2d(MaxPool2d):
    def forward(self, x):
        return self._ff().pool2d(x, *self.kernel_size, *self.stride,
                                 *self.padding, pool_type="avg",
                                 name=self.name)


class Linear(_LayerModule):
    def __init__(self, in_features, out_features, bias=True):
        self.in_features, self.out_features = in_features, out_features
        self.bias = bias

    def forward(self, x):
        assert x.shape[-1] == self.in_features, (x.shape, self.in_features)
        return self._ff().dense(x, self.out_features, use_bias=self.bias,
                                name=self.name)


class Embedding(_LayerModule):
    def __init__(self, num_embeddings, embedding_dim):
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim

    def forward(self, x):
        return self._ff().embedding(x, self.num_embeddings,
                                    self.embedding_dim, aggr="none",
                                    name=self.name)


class Flatten(_LayerModule):
    def __init__(self, start_dim=1):
        assert start_dim == 1, "only start_dim=1 is supported"

    def forward(self, x):
        return self._ff().flat(x, name=self.name)


class _Act(_LayerModule):
    fn = "relu"

    def __init__(self, inplace=False):
        pass

    def forward(self, x):
        return self._ff()._unary(self.fn, x, name=self.name)


class ReLU(_Act):
    fn = "relu"


class Sigmoid(_Act):
    fn = "sigmoid"


class Tanh(_Act):
    fn = "tanh"


class GELU(_Act):
    fn = "gelu"


class Identity(_Act):
    fn = "identity"


class Softmax(_LayerModule):
    def __init__(self, dim=-1):
        self.dim = dim

    def forward(self, x):
        return self._ff().softmax(x, axis=self.dim, name=self.name)


class Dropout(_LayerModule):
    def __init__(self, p=0.5):
        self.p = p

    def forward(self, x):
        return self._ff().dropout(x, self.p, name=self.name)


class BatchNorm2d(_LayerModule):
    def __init__(self, num_features, eps=1e-5, momentum=0.9):
        self.num_features = num_features
        self.eps, self.momentum = eps, momentum

    def forward(self, x):
        return self._ff().batch_norm(x, relu=False, momentum=self.momentum,
                                     eps=self.eps, name=self.name)


class Module:
    """reference modules/module.py: owns FFConfig + FFModel; attribute
    assignment registers layers.  Not a ``torch.nn.Module``: it holds no
    tensors of its own, its ``forward`` builds an FFModel graph.
    ``config`` defaults to the process default (the runner's flags); the
    model runs on the process's default device, else the card, which
    must then be present."""

    def __init__(self, config: Optional[FFConfig] = None):
        object.__setattr__(self, "_layers", {})
        if config is None:
            # pick up the flexflow-tpu-torch runner's parsed flags (cli.py)
            config = get_default_config()
        self.ffconfig = config
        self.ffmodel = FFModel(self.ffconfig)

    def __setattr__(self, name, value):
        if isinstance(value, _LayerModule):
            value._module = self
            value.name = name
            self._layers[name] = value
        object.__setattr__(self, name, value)

    def __call__(self, x):
        return self.forward(x)

    def create_input(self, shape, dtype="float32", name="input"):
        return self.ffmodel.create_tensor(shape, dtype=dtype, name=name)

    # training conveniences delegating to the core model
    def compile(self, optimizer, loss_type, metrics=(), **kw):
        self.ffmodel.compile(optimizer, loss_type, list(metrics), **kw)
        self.ffmodel.init_layers(seed=self.ffconfig.seed)

    def fit(self, x, y, **kw):
        return self.ffmodel.fit(x, y, **kw)

    def evaluate(self, x, y, **kw):
        return self.ffmodel.evaluate(x, y, **kw)

    def predict(self, x, **kw):
        return self.ffmodel.predict(x, **kw)

    def parameters(self):
        return list(self.ffmodel.parameters)
