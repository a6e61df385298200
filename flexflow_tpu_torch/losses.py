"""Loss names, as ``flexflow_tpu/losses.py`` spells them.

``FFModel.compile`` stores the loss type and applies the reference's
label-tensor and softmax-input rules from these names; the loss
functions themselves come with the training slice.
"""

from __future__ import annotations

SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
MEAN_SQUARED_ERROR = "mean_squared_error"
MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error_avg_reduce"
MEAN_SQUARED_ERROR_SUM_REDUCE = "mean_squared_error_sum_reduce"
IDENTITY = "identity"


def uses_logits(loss_type: str) -> bool:
    """Sparse-CCE consumes raw logits (fused softmax path); CCE/MSE
    consume the final op's output as-is."""
    return loss_type in (SPARSE_CATEGORICAL_CROSSENTROPY,
                         "sparse_crossentropy", "scce")
