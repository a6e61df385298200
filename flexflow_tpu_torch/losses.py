"""Loss functions, the counterpart of ``flexflow_tpu/losses.py``.

Each loss is a per-example function plus a batch reduction ("mean" or
"sum"); the scalar training loss is the reduction of the per-example
losses, and autograd produces the seeded logit gradient the reference's
loss task writes by hand.  Losses reduce in float32.
"""

from __future__ import annotations

import torch

SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
MEAN_SQUARED_ERROR = "mean_squared_error"
MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error_avg_reduce"
MEAN_SQUARED_ERROR_SUM_REDUCE = "mean_squared_error_sum_reduce"
IDENTITY = "identity"


def _per_example_scce(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Fused log-softmax CE on *logits*.  labels: int (batch,) or
    (batch, 1); for sequence models logits (batch, seq, vocab) + labels
    (batch, seq) give the per-example mean over tokens."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    if logits.dim() == 3:
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return (logz - ll).mean(dim=-1)
    labels = labels.reshape(labels.shape[0]).long()
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    return logz - ll


def _per_example_cce(probs: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    probs = probs.to(torch.float32)
    return -torch.sum(labels * torch.log(probs + 1e-8), dim=-1)


def _sq_diff(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    d = preds.to(torch.float32) - labels.to(torch.float32)
    return torch.square(d).reshape(d.shape[0], -1)


def _per_example_sq(preds, labels):
    return _sq_diff(preds, labels).sum(dim=-1)


def _per_example_sq_mean(preds, labels):
    return _sq_diff(preds, labels).mean(dim=-1)


# per-example loss + batch reduction ("mean" over samples or "sum").
# The scalar loss used for training grads is reduction(per_example).
_LOSSES = {
    SPARSE_CATEGORICAL_CROSSENTROPY: (_per_example_scce, "mean"),
    CATEGORICAL_CROSSENTROPY: (_per_example_cce, "mean"),
    MEAN_SQUARED_ERROR: (_per_example_sq, "mean"),
    MEAN_SQUARED_ERROR_AVG_REDUCE: (_per_example_sq_mean, "mean"),
    MEAN_SQUARED_ERROR_SUM_REDUCE: (_per_example_sq, "sum"),
}

_ALIASES = {
    "sparse_crossentropy": SPARSE_CATEGORICAL_CROSSENTROPY,
    "scce": SPARSE_CATEGORICAL_CROSSENTROPY,
    "cce": CATEGORICAL_CROSSENTROPY,
    "mse": MEAN_SQUARED_ERROR,
}


def _canon(loss_type: str) -> str:
    loss_type = _ALIASES.get(loss_type, loss_type)
    if loss_type not in _LOSSES:
        raise ValueError(f"unknown loss {loss_type!r}")
    return loss_type


def get_per_example_loss_fn(loss_type: str):
    """(per_example_fn, reduction) — per-row losses for masked
    evaluation."""
    return _LOSSES[_canon(loss_type)]


def get_loss_fn(loss_type: str):
    per_ex, reduction = _LOSSES[_canon(loss_type)]
    red = torch.mean if reduction == "mean" else torch.sum

    def fn(preds, labels):
        return red(per_ex(preds, labels))

    return fn


def uses_logits(loss_type: str) -> bool:
    """Sparse-CCE consumes raw logits (fused softmax path); CCE/MSE
    consume the final op's output as-is."""
    return loss_type in (SPARSE_CATEGORICAL_CROSSENTROPY,
                         "sparse_crossentropy", "scce")
