"""flexflow_tpu_torch.serving.generation — token generation: KV-cached
autoregressive decode over an FFModel graph on a paged KV pool, and the
continuous-batching :class:`GenerationEngine` with streaming outputs,
the port of ``flexflow_tpu/serving/generation``."""

from .decoder import GraphDecoder
from .engine import GenerationEngine, GenerationMetrics, GenerationStream
from .sampling import SamplingParams

__all__ = ["GenerationEngine", "GenerationStream", "GenerationMetrics",
           "GraphDecoder", "SamplingParams"]
