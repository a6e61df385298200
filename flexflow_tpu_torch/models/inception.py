"""InceptionV3, the topology of ``flexflow_tpu/models/inception.py``
(reference ``examples/cpp/InceptionV3/inception.cc``): stem convs and two
3x3/2 max pools, then 3 x InceptionA, InceptionB, 4 x InceptionC,
InceptionD and 2 x InceptionE, each module's branches joined by a
channel concat, then a global average pool, flat, dense and softmax.
The module builders are kept as separate functions, as in the JAX
package, so that a test can build one module alone."""

from __future__ import annotations

from typing import Tuple

from ..config import FFConfig
from ..model import FFModel
from ..tensor import Tensor


def _inception_a(ff: FFModel, x: Tensor, pool_features: int) -> Tensor:
    b1 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation="relu")
    b2 = ff.conv2d(x, 48, 1, 1, 1, 1, 0, 0, activation="relu")
    b2 = ff.conv2d(b2, 64, 5, 5, 1, 1, 2, 2, activation="relu")
    b3 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation="relu")
    b3 = ff.conv2d(b3, 96, 3, 3, 1, 1, 1, 1, activation="relu")
    b3 = ff.conv2d(b3, 96, 3, 3, 1, 1, 1, 1, activation="relu")
    b4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg")
    b4 = ff.conv2d(b4, pool_features, 1, 1, 1, 1, 0, 0, activation="relu")
    return ff.concat([b1, b2, b3, b4], axis=1)


def _inception_b(ff: FFModel, x: Tensor) -> Tensor:
    b1 = ff.conv2d(x, 384, 3, 3, 2, 2, 0, 0)
    b2 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(b2, 96, 3, 3, 1, 1, 1, 1)
    b2 = ff.conv2d(b2, 96, 3, 3, 2, 2, 0, 0)
    b3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([b1, b2, b3], axis=1)


def _inception_c(ff: FFModel, x: Tensor, channels: int) -> Tensor:
    b1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(b2, channels, 1, 7, 1, 1, 0, 3)
    b2 = ff.conv2d(b2, 192, 7, 1, 1, 1, 3, 0)
    b3 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    b3 = ff.conv2d(b3, channels, 7, 1, 1, 1, 3, 0)
    b3 = ff.conv2d(b3, channels, 1, 7, 1, 1, 0, 3)
    b3 = ff.conv2d(b3, channels, 7, 1, 1, 1, 3, 0)
    b3 = ff.conv2d(b3, 192, 1, 7, 1, 1, 0, 3)
    b4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg")
    b4 = ff.conv2d(b4, 192, 1, 1, 1, 1, 0, 0)
    return ff.concat([b1, b2, b3, b4], axis=1)


def _inception_d(ff: FFModel, x: Tensor) -> Tensor:
    b1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    b1 = ff.conv2d(b1, 320, 3, 3, 2, 2, 0, 0)
    b2 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(b2, 192, 1, 7, 1, 1, 0, 3)
    b2 = ff.conv2d(b2, 192, 7, 1, 1, 1, 3, 0)
    b2 = ff.conv2d(b2, 192, 3, 3, 2, 2, 0, 0)
    b3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([b1, b2, b3], axis=1)


def _inception_e(ff: FFModel, x: Tensor) -> Tensor:
    b1 = ff.conv2d(x, 320, 1, 1, 1, 1, 0, 0)
    b2i = ff.conv2d(x, 384, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(b2i, 384, 1, 3, 1, 1, 0, 1)
    b3 = ff.conv2d(b2i, 384, 3, 1, 1, 1, 1, 0)
    b4i = ff.conv2d(x, 448, 1, 1, 1, 1, 0, 0)
    b4i = ff.conv2d(b4i, 384, 3, 3, 1, 1, 1, 1)
    b4 = ff.conv2d(b4i, 384, 1, 3, 1, 1, 0, 1)
    b5 = ff.conv2d(b4i, 384, 3, 1, 1, 1, 1, 0)
    b6 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg")
    b6 = ff.conv2d(b6, 192, 1, 1, 1, 1, 0, 0)
    return ff.concat([b1, b2, b3, b4, b5, b6], axis=1)


def build_inception_v3(config: FFConfig, num_classes: int = 10,
                       image_size: int = 299,
                       device=None) -> Tuple[FFModel, Tensor, Tensor]:
    ff = FFModel(config, device=device)
    inp = ff.create_tensor(
        (config.batch_size, 3, image_size, image_size), name="input")
    t = ff.conv2d(inp, 32, 3, 3, 2, 2, 0, 0, activation="relu")
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0, activation="relu")
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0, activation="relu")
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1, activation="relu")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    for pool_features in (32, 64, 64):
        t = _inception_a(ff, t, pool_features)
    t = _inception_b(ff, t)
    for channels in (128, 160, 160, 192):
        t = _inception_c(ff, t, channels)
    t = _inception_d(ff, t)
    t = _inception_e(ff, t)
    t = _inception_e(ff, t)
    hw = t.shape[2]   # global average pool over what remains
    t = ff.pool2d(t, hw, hw, 1, 1, 0, 0, pool_type="avg")
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    logits = t
    t = ff.softmax(t)
    return ff, inp, logits
