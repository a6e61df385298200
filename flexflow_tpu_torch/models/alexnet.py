"""AlexNet, the topology of ``flexflow_tpu/models/alexnet.py``: 5 conv +
3 max pool + flat + 3 dense + softmax, 229x229 input, 10 classes."""

from __future__ import annotations

from typing import Tuple

from ..config import FFConfig
from ..model import FFModel
from ..tensor import Tensor


def build_alexnet(config: FFConfig, num_classes: int = 10,
                  image_size: int = 229,
                  device=None) -> Tuple[FFModel, Tensor, Tensor]:
    ff = FFModel(config, device=device)
    inp = ff.create_tensor(
        (config.batch_size, 3, image_size, image_size), name="input")
    t = ff.conv2d(inp, 64, 11, 11, 4, 4, 2, 2, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 4096, activation="relu")
    t = ff.dense(t, 4096, activation="relu")
    t = ff.dense(t, num_classes)
    logits = t
    t = ff.softmax(t)
    return ff, inp, logits
