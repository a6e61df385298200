"""Model builders ported so far."""

from .alexnet import build_alexnet
from .candle_uno import build_candle_uno
from .dlrm import build_dlrm
from .inception import build_inception_v3
from .nmt import build_lstm_lm, build_nmt
from .resnet import build_resnet50
from .transformer import build_transformer, build_transformer_lm

__all__ = ["build_alexnet", "build_candle_uno", "build_dlrm",
           "build_inception_v3", "build_lstm_lm", "build_nmt",
           "build_resnet50", "build_transformer", "build_transformer_lm"]
