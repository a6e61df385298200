"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

A second package beside the JAX one: the FFModel graph API and its
operators in PyTorch, running on an NVIDIA GPU (Hopper), with the JAX
package's Pallas kernels rewritten by hand in CUDA (``csrc/``).  It
imports neither jax nor flexflow_tpu.  Entry points run on CUDA unless
the caller passes ``device="cpu"``.
"""

from . import losses, metrics, resilience
from .config import DeviceType, FFConfig, MemoryType, ParallelConfig
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
from .serving import (DeadlineExceeded, GenerationCancelled,
                      GenerationEngine, GenerationStream, KVCacheExhausted,
                      OverloadError, SamplingParams, ServingEngine,
                      ServingError, SheddedError)
from .tensor import Parameter, Tensor

__all__ = ["DeviceType", "FFConfig", "MemoryType",
           "ParallelConfig", "ConstantInitializer", "GlorotUniform",
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
           "Optimizer", "SGDOptimizer", "synthetic_dataset", "losses",
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
