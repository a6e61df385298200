"""Model builders ported so far."""

from .alexnet import build_alexnet

__all__ = ["build_alexnet"]
