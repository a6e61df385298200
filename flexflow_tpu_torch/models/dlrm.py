"""DLRM, the topology of ``flexflow_tpu/models/dlrm.py`` (the reference's
``examples/cpp/DLRM/dlrm.cc``): a bottom MLP over the dense features,
one sum-bag embedding per sparse feature (``embedding{i}``), ``cat``
feature interaction, a top MLP whose second-to-last layer is sigmoid,
and the op-form ``mse_loss``.  Init follows create_mlp: Norm(0,
sqrt(2/(fan_in+fan_out))) kernels, Norm(0, sqrt(2/fan_out)) biases,
Uniform(±sqrt(1/rows)) tables."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from ..config import FFConfig
from ..initializers import NormInitializer, UniformInitializer
from ..model import FFModel
from ..tensor import Tensor


def create_mlp(ff: FFModel, t: Tensor, ln: Sequence[int],
               sigmoid_layer: int, prefix: str) -> Tensor:
    for i in range(len(ln) - 1):
        std = math.sqrt(2.0 / (ln[i + 1] + ln[i]))
        w_init = NormInitializer(mean=0.0, stddev=std)
        b_init = NormInitializer(mean=0.0, stddev=math.sqrt(2.0 / ln[i + 1]))
        act = "sigmoid" if i == sigmoid_layer else "relu"
        t = ff.dense(t, ln[i + 1], activation=act, kernel_initializer=w_init,
                     bias_initializer=b_init, name=f"{prefix}_dense_{i}")
    return t


def interact_features(ff: FFModel, x: Tensor, ly: List[Tensor],
                      interaction: str = "cat") -> Tensor:
    if interaction != "cat":  # the reference has only cat (dlrm.cc:50-66)
        raise NotImplementedError(interaction)
    return ff.concat([x] + ly, axis=1, name="interact")


def build_dlrm(config: FFConfig,
               embedding_size: Sequence[int] = (1000000, 1000000, 1000000,
                                                1000000),
               sparse_feature_size: int = 64,
               embedding_bag_size: int = 1,
               mlp_bot: Sequence[int] = (256, 512, 64),
               mlp_top: Sequence[int] = (576, 512, 256, 1),
               sigmoid_bot: int = -1, sigmoid_top: Optional[int] = None,
               device=None) -> Tuple[FFModel, Tuple[Tensor, ...], Tensor]:
    """Returns (model, (sparse_0..sparse_k, dense_input), predictions);
    labels are (batch, 1) float targets for the MSE loss.  The defaults
    are the JAX builder's, whose ``mlp_top[0]`` (576) is not the width
    of four 64-wide tables beside a 64-wide bottom MLP (320): pass
    ``mlp_top`` with that width, as ``bench.py`` does."""
    ff = FFModel(config, device=device)
    n = config.batch_size
    sparse_inputs = [ff.create_tensor((n, embedding_bag_size), dtype="int32",
                                      name=f"sparse_{i}")
                     for i in range(len(embedding_size))]
    dense_input = ff.create_tensor((n, mlp_bot[0]), name="dense_input")
    x = create_mlp(ff, dense_input, mlp_bot, sigmoid_bot, "bot")
    ly = []
    for i, vocab in enumerate(embedding_size):
        rng = math.sqrt(1.0 / vocab)
        ly.append(ff.embedding(
            sparse_inputs[i], vocab, sparse_feature_size, aggr="sum",
            kernel_initializer=UniformInitializer(minv=-rng, maxv=rng),
            name=f"embedding{i}"))
    z = interact_features(ff, x, ly)
    if z.shape[1] != mlp_top[0]:
        raise ValueError(f"the interaction is {z.shape[1]} wide but "
                         f"mlp_top[0] is {mlp_top[0]}")
    if sigmoid_top is None:
        sigmoid_top = len(mlp_top) - 2  # dlrm.cc:128 convention
    p = create_mlp(ff, z, mlp_top, sigmoid_top, "top")
    preds = ff.mse_loss(p, reduction="average")
    return ff, tuple(sparse_inputs) + (dense_input,), preds
