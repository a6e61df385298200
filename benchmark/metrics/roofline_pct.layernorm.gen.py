"""The fused LayerNorm kernel's share of its byte bound in the
generation window: 2 launches a layer over every prompt token prefilled
and every token decoded in the window, compute dtype in and out."""

from portbench.readers import LAYERNORM_COUNTERS as KERNELS  # noqa: F401
from portbench.readers import layernorm_roofline_pct as read  # noqa: F401
