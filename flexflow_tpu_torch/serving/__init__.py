"""The port's inference-serving subsystem: bucketed forwards plus a
dynamic micro-batcher over a compiled FFModel, and paged token
generation (``serving.generation``)."""

from .batcher import (ADMISSION_POLICIES, MicroBatcher, Request, bucket_for,
                      derive_buckets, split_sizes)
from .engine import HEALTH_STATES, ServingEngine
from .errors import (DeadlineExceeded, GenerationCancelled,
                     KVCacheExhausted, OverloadError, ServingError,
                     SheddedError)
from .generation import (GenerationEngine, GenerationMetrics,
                         GenerationStream, GraphDecoder, SamplingParams)
from .metrics import ServingMetrics, quantiles

__all__ = ["ServingEngine", "MicroBatcher", "Request", "ServingMetrics",
           "ServingError", "OverloadError", "SheddedError",
           "DeadlineExceeded", "GenerationCancelled", "KVCacheExhausted",
           "GenerationEngine", "GenerationMetrics", "GenerationStream",
           "GraphDecoder", "SamplingParams", "ADMISSION_POLICIES",
           "HEALTH_STATES",
           "bucket_for", "derive_buckets", "split_sizes", "quantiles"]
