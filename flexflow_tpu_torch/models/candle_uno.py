"""CANDLE-Uno, the topology of ``flexflow_tpu/models/candle_uno.py``
(the reference's ``examples/cpp/candle_uno/candle_uno.cc``): a dense-relu
encoder tower for each input wider than one feature (cell rnaseq, drug
descriptors, drug fingerprints), the dose scalars passed as they are, a
concat of all five, a dense-relu trunk, a 1-unit head and the op-form
MSE loss."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..config import FFConfig
from ..model import FFModel
from ..tensor import Tensor

# the reference's defaults (candle_uno.h:24-37)
DEFAULT_FEATURE_SHAPES: Dict[str, int] = {
    "dose": 1,
    "cell.rnaseq": 942,
    "drug.descriptors": 5270,
    "drug.fingerprints": 2048,
}
DEFAULT_INPUT_FEATURES: Dict[str, str] = {
    "dose1": "dose",
    "dose2": "dose",
    "cell.rnaseq": "cell.rnaseq",
    "drug1.descriptors": "drug.descriptors",
    "drug1.fingerprints": "drug.fingerprints",
}


def build_feature_model(ff: FFModel, t: Tensor, dense_layers: List[int],
                        prefix: str) -> Tensor:
    for i, units in enumerate(dense_layers):
        t = ff.dense(t, units, activation="relu",
                     name=f"{prefix}_dense_{i}")
    return t


def build_candle_uno(config: FFConfig,
                     dense_layers: Tuple[int, ...] = (1000,) * 3,
                     dense_feature_layers: Tuple[int, ...] = (1000,) * 3,
                     feature_shapes: Dict[str, int] = None,
                     input_features: Dict[str, str] = None,
                     device=None) -> Tuple[FFModel, List[Tensor], Tensor]:
    """Returns (model, inputs, predictions); labels are (batch, 1)
    floats."""
    feature_shapes = feature_shapes or DEFAULT_FEATURE_SHAPES
    input_features = input_features or DEFAULT_INPUT_FEATURES
    ff = FFModel(config, device=device)
    n = config.batch_size
    # every feature kind wider than 1 is an "input model" with a tower
    # (candle_uno.cc:93-101)
    input_models = {k for k, shape in feature_shapes.items() if shape > 1}
    all_inputs, encoded = [], []
    for name, kind in input_features.items():
        inp = ff.create_tensor((n, feature_shapes[kind]),
                               name=name.replace(".", "_"))
        all_inputs.append(inp)
        if kind in input_models:
            encoded.append(build_feature_model(
                ff, inp, list(dense_feature_layers),
                prefix=name.replace(".", "_")))
        else:
            encoded.append(inp)
    out = ff.concat(encoded, axis=1, name="concat")
    for i, units in enumerate(dense_layers):
        out = ff.dense(out, units, activation="relu", name=f"trunk_dense_{i}")
    out = ff.dense(out, 1, name="head")
    preds = ff.mse_loss(out, reduction="average")
    return ff, all_inputs, preds
