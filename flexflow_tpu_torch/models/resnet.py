"""ResNet-50, the topology of ``flexflow_tpu/models/resnet.py``
(reference ``examples/cpp/ResNet/resnet.cc``): a 7x7/2 stem conv, a 3x3/2
max pool with padding 1, then 3/4/6/3 bottleneck blocks at 64/128/256/512
channels (1x1 reduce, 3x3, 1x1 expand, a residual add, and a projecting
shortcut conv with ReLU where the shape changes), a global average pool,
flat, dense and softmax.  Conv-only like the reference by default;
``batch_norm=True`` adds a BatchNorm after each conv of a block."""

from __future__ import annotations

from typing import Tuple

from ..config import FFConfig
from ..model import FFModel
from ..tensor import Tensor


def _bottleneck(ff: FFModel, x: Tensor, out_channels: int, stride: int,
                batch_norm: bool = False) -> Tensor:
    t = ff.conv2d(x, out_channels, 1, 1, 1, 1, 0, 0, activation="relu")
    if batch_norm:
        t = ff.batch_norm(t)
    t = ff.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1,
                  activation="relu")
    if batch_norm:
        t = ff.batch_norm(t)
    t = ff.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0)
    if batch_norm:
        t = ff.batch_norm(t, relu=False)
    if stride > 1 or x.shape[1] != 4 * out_channels:
        x = ff.conv2d(x, 4 * out_channels, 1, 1, stride, stride, 0, 0,
                      activation="relu")
    return ff.add(x, t)


def build_resnet50(config: FFConfig, num_classes: int = 10,
                   image_size: int = 229, batch_norm: bool = False,
                   device=None) -> Tuple[FFModel, Tensor, Tensor]:
    ff = FFModel(config, device=device)
    inp = ff.create_tensor(
        (config.batch_size, 3, image_size, image_size), name="input")
    t = ff.conv2d(inp, 64, 7, 7, 2, 2, 3, 3)
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1)
    for channels, blocks in ((64, 3), (128, 4), (256, 6), (512, 3)):
        for i in range(blocks):
            stride = 2 if i == 0 and channels > 64 else 1
            t = _bottleneck(ff, t, channels, stride, batch_norm)
    hw = t.shape[2]
    t = ff.pool2d(t, hw, hw, 1, 1, 0, 0, pool_type="avg")
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    logits = t
    t = ff.softmax(t)
    return ff, inp, logits
