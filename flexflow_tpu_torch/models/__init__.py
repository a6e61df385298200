"""Model builders ported so far."""

from .alexnet import build_alexnet
from .transformer import build_transformer, build_transformer_lm

__all__ = ["build_alexnet", "build_transformer", "build_transformer_lm"]
