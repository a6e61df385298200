"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

A second package beside the JAX one: the FFModel graph API and its
operators in PyTorch, running on an NVIDIA GPU (Hopper), with the JAX
package's Pallas kernels rewritten by hand in CUDA (``csrc/``).  It
imports neither jax nor flexflow_tpu.  Entry points run on CUDA unless
the caller passes ``device="cpu"`` or the process has a default device
(:func:`set_default_device`, the runner's ``--device``, or the
``FLEXFLOW_PLATFORM`` environment variable read at import: ``cpu``, or
``cuda``/``gpu``; the JAX package reads the same variable).  On several
devices it runs one process per device and a ``MachineMesh`` over them
(``parallel/distributed.py``).

The frontends sit on top: ``flexflow_tpu_torch.keras`` (Sequential and
functional models), ``flexflow_tpu_torch.nn_compat`` (the torch.nn-style
module API) and the ``flexflow-tpu-torch`` script runner (``cli.py``),
which installs the parsed flags as the default config
(:func:`set_default_config`, :func:`get_default_config`).
"""

from . import losses, metrics, resilience
from .config import (DeviceType, FFConfig, MemoryType, ParallelConfig,
                     get_default_config, get_default_device,
                     platform_device, set_default_config,
                     set_default_device)
from .data import synthetic_dataset
from .initializers import (ConstantInitializer, GlorotUniform,
                           NormInitializer, UniformInitializer,
                           ZeroInitializer)
from .metrics import PerfMetrics
from .model import FFModel
from .models import (build_alexnet, build_candle_uno, build_dlrm,
                     build_inception_v3, build_lstm_lm, build_nmt,
                     build_resnet50, build_transformer,
                     build_transformer_lm)
from .op import Op, OpContext, OpType
from .ops.attention import MultiHeadAttention, PositionEmbedding
from .ops.elementwise import ElementBinary, ElementUnary
from .ops.linear import Embedding, Linear
from .ops.loss_ops import MSELoss
from .ops.moe import MoE
from .ops.norm import BatchNorm, LayerNorm, RMSNorm
from .ops.rnn import LSTM
from .ops.tensor_ops import Concat, Dropout, Reshape, Split, Transpose
from .optimizers import AdamOptimizer, Optimizer, SGDOptimizer
from .parallel.distributed import (finalize_distributed,
                                   initialize_distributed)
from .parallel.mesh import MachineMesh
from .serving import (DeadlineExceeded, GenerationCancelled,
                      GenerationEngine, GenerationStream, KVCacheExhausted,
                      OverloadError, SamplingParams, ServingEngine,
                      ServingError, SheddedError)
from .tensor import Parameter, Tensor

# FLEXFLOW_PLATFORM, where set, names the default device (a C host has no
# device argument; see config.platform_device)
set_default_device(platform_device())

__all__ = ["DeviceType", "FFConfig", "MemoryType",
           "ParallelConfig", "get_default_config", "get_default_device",
           "set_default_config", "set_default_device", "ConstantInitializer", "GlorotUniform",
           "NormInitializer", "UniformInitializer", "ZeroInitializer",
           "FFModel", "Op", "OpContext", "OpType", "DeadlineExceeded",
           "build_alexnet", "build_candle_uno", "build_dlrm",
           "build_inception_v3", "build_lstm_lm", "build_nmt",
           "build_resnet50", "build_transformer", "build_transformer_lm",
           "MultiHeadAttention", "PositionEmbedding", "ElementBinary",
           "ElementUnary", "Embedding", "Linear", "LSTM", "MSELoss", "MoE",
           "BatchNorm", "LayerNorm", "RMSNorm", "Concat",
           "Dropout", "Reshape", "Split", "Transpose", "resilience",
           "OverloadError", "ServingEngine", "ServingError", "SheddedError",
           "GenerationCancelled", "GenerationEngine", "GenerationStream",
           "KVCacheExhausted", "SamplingParams",
           "Parameter", "Tensor", "PerfMetrics", "AdamOptimizer",
           "Optimizer", "SGDOptimizer", "MachineMesh",
           "initialize_distributed", "finalize_distributed",
           "synthetic_dataset", "losses",
           "metrics", "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY",
           "LOSS_CATEGORICAL_CROSSENTROPY", "LOSS_MEAN_SQUARED_ERROR",
           "METRICS_ACCURACY", "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY",
           "METRICS_CATEGORICAL_CROSSENTROPY", "METRICS_MEAN_SQUARED_ERROR"]

LOSS_SPARSE_CATEGORICAL_CROSSENTROPY = losses.SPARSE_CATEGORICAL_CROSSENTROPY
LOSS_CATEGORICAL_CROSSENTROPY = losses.CATEGORICAL_CROSSENTROPY
LOSS_MEAN_SQUARED_ERROR = losses.MEAN_SQUARED_ERROR
METRICS_ACCURACY = metrics.ACCURACY
METRICS_SPARSE_CATEGORICAL_CROSSENTROPY = \
    metrics.SPARSE_CATEGORICAL_CROSSENTROPY
METRICS_CATEGORICAL_CROSSENTROPY = metrics.CATEGORICAL_CROSSENTROPY
METRICS_MEAN_SQUARED_ERROR = metrics.MEAN_SQUARED_ERROR
