"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

A second package beside the JAX one: the FFModel graph API and its
operators in PyTorch, running on an NVIDIA GPU (Hopper), with the JAX
package's Pallas kernels rewritten by hand in CUDA (``csrc/``).  It
imports neither jax nor flexflow_tpu.  Entry points run on CUDA unless
the caller passes ``device="cpu"``.
"""

from .config import DeviceType, FFConfig, MemoryType, ParallelConfig
from .initializers import (ConstantInitializer, GlorotUniform,
                           NormInitializer, UniformInitializer,
                           ZeroInitializer)
from .model import FFModel
from .op import Op, OpContext, OpType
from .serving import (DeadlineExceeded, OverloadError, ServingEngine,
                      ServingError, SheddedError)
from .tensor import Parameter, Tensor

__all__ = ["DeviceType", "FFConfig", "MemoryType",
           "ParallelConfig", "ConstantInitializer", "GlorotUniform",
           "NormInitializer", "UniformInitializer", "ZeroInitializer",
           "FFModel", "Op", "OpContext", "OpType", "DeadlineExceeded",
           "OverloadError", "ServingEngine", "ServingError", "SheddedError",
           "Parameter", "Tensor"]
