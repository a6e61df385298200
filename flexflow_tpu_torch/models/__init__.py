"""Model builders ported so far."""

from .alexnet import build_alexnet
from .inception import build_inception_v3
from .resnet import build_resnet50
from .transformer import build_transformer, build_transformer_lm

__all__ = ["build_alexnet", "build_inception_v3", "build_resnet50",
           "build_transformer", "build_transformer_lm"]
