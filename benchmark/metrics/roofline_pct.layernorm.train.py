"""The fused LayerNorm kernel's share of its byte bound in the training
window: 2 launches a layer a step over batch x sequence rows of the
model width, compute dtype in and out (the backward is not the
kernel's)."""

from portbench.readers import LAYERNORM_COUNTERS as KERNELS  # noqa: F401
from portbench.readers import layernorm_roofline_pct as read  # noqa: F401
