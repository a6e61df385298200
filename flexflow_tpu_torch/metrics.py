"""Metrics and PerfMetrics, the counterpart of ``flexflow_tpu/metrics.py``.

``compute_batch_metrics`` returns per-batch metric *sums* as device
tensors, so a training loop can keep them on the device and fetch them
once per epoch; ``PerfMetrics`` is the host-side fold across batches
(the reference's UPDATE_METRICS_TASK) and prints the reference's report
line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

ACCURACY = "accuracy"
CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
MEAN_SQUARED_ERROR = "mean_squared_error"
ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
MEAN_ABSOLUTE_ERROR = "mean_absolute_error"

KNOWN_METRICS = (ACCURACY, CATEGORICAL_CROSSENTROPY,
                 SPARSE_CATEGORICAL_CROSSENTROPY, MEAN_SQUARED_ERROR,
                 ROOT_MEAN_SQUARED_ERROR, MEAN_ABSOLUTE_ERROR)

# keras-style spellings accepted by FFModel.compile; an unknown name
# raises rather than silently measuring nothing
_ALIASES = {
    "acc": ACCURACY,
    "categorical_accuracy": ACCURACY,
    "sparse_categorical_accuracy": ACCURACY,
    "cce": CATEGORICAL_CROSSENTROPY,
    "scce": SPARSE_CATEGORICAL_CROSSENTROPY,
    "mse": MEAN_SQUARED_ERROR,
    "rmse": ROOT_MEAN_SQUARED_ERROR,
    "mae": MEAN_ABSOLUTE_ERROR,
}


def canonicalize_metrics(names: Sequence[str]) -> List[str]:
    """Map aliases onto canonical names; reject unknown metrics loudly."""
    out = []
    for m in names:
        c = _ALIASES.get(m, m)
        if c not in KNOWN_METRICS:
            raise ValueError(
                f"unknown metric {m!r}; known: {list(KNOWN_METRICS)} "
                f"(+ aliases {sorted(_ALIASES)})")
        out.append(c)
    return out


@dataclasses.dataclass
class PerfMetrics:
    """Host-side fold of per-iteration metric sums (reference
    metrics_functions.h:25-44)."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0
    has_accuracy: bool = False  # accuracy metric enabled (vs value 0)
    val_scalars: Dict[str, float] = dataclasses.field(default_factory=dict)

    def update(self, batch_sums) -> None:
        """Fold one batch's sums (host numbers, numpy values or tensors)."""
        self.train_all += int(batch_sums.get("count", 0))
        if "correct" in batch_sums:
            self.has_accuracy = True
        self.train_correct += int(batch_sums.get("correct", 0))
        self.cce_loss += float(batch_sums.get("cce", 0.0))
        self.sparse_cce_loss += float(batch_sums.get("scce", 0.0))
        self.mse_loss += float(batch_sums.get("mse", 0.0))
        self.rmse_loss += float(batch_sums.get("rmse", 0.0))
        self.mae_loss += float(batch_sums.get("mae", 0.0))

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(1, self.train_all)

    def scalars(self) -> Dict[str, float]:
        """Per-sample means of every nonzero accumulator."""
        n = max(1, self.train_all)
        out: Dict[str, float] = {"samples_seen": float(self.train_all)}
        if self.has_accuracy:  # 0% accuracy is a value, not "disabled"
            out["accuracy"] = self.accuracy
        for k, v in (("cce", self.cce_loss), ("scce", self.sparse_cce_loss),
                     ("mse", self.mse_loss), ("rmse", self.rmse_loss),
                     ("mae", self.mae_loss)):
            if v:
                out[k] = v / n
        return out

    def report(self, metrics: Sequence[str]) -> str:
        """Format like metrics_functions.cc:59-86."""
        parts = []
        n = max(1, self.train_all)
        if ACCURACY in metrics:
            parts.append(
                f"accuracy: {100.0 * self.accuracy:.2f}% "
                f"({self.train_correct} / {self.train_all})")
        if CATEGORICAL_CROSSENTROPY in metrics:
            parts.append(f"cce_loss: {self.cce_loss / n:.6f}")
        if SPARSE_CATEGORICAL_CROSSENTROPY in metrics:
            parts.append(f"sparse_cce_loss: {self.sparse_cce_loss / n:.6f}")
        if MEAN_SQUARED_ERROR in metrics:
            parts.append(f"mse_loss: {self.mse_loss / n:.6f}")
        if ROOT_MEAN_SQUARED_ERROR in metrics:
            parts.append(f"rmse_loss: {self.rmse_loss / n:.6f}")
        if MEAN_ABSOLUTE_ERROR in metrics:
            parts.append(f"mae_loss: {self.mae_loss / n:.6f}")
        return "  ".join(parts)


def _per_row_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def compute_batch_metrics(preds: torch.Tensor, labels: torch.Tensor,
                          metric_names: Sequence[str], loss_type: str,
                          nvalid=None) -> Dict[str, torch.Tensor]:
    """Per-batch metric *sums* (not means), so the host fold matches the
    reference's accumulate-then-divide semantics.  ``nvalid`` masks out
    padded tail rows: only the first ``nvalid`` samples contribute."""
    bs = preds.shape[0]
    dev = preds.device
    # torch.full, not torch.tensor: a host-to-device copy of a Python
    # number would wait for the device every batch
    if nvalid is None:
        mask = torch.ones((bs,), dtype=torch.float32, device=dev)
        count = torch.full((), bs, dtype=torch.int32, device=dev)
    else:
        mask = (torch.arange(bs, device=dev) < nvalid).to(torch.float32)
        count = torch.full((), int(nvalid), dtype=torch.int32, device=dev)
    if preds.dim() == 3 and labels.dim() == 2:
        # sequence model (n, s, vocab) + token labels (n, s): fold tokens
        # into the sample dim so every metric is per-token
        s = preds.shape[1]
        preds = preds.reshape(bs * s, preds.shape[-1])
        labels = labels.reshape(bs * s, 1)
        mask = mask.repeat_interleave(s)
        count = count * s
    out: Dict[str, torch.Tensor] = {"count": count}
    pf = preds.to(torch.float32)
    for m in metric_names:
        if m == ACCURACY:
            if labels.dim() == 1 or labels.shape[-1] == 1:
                lab = labels.reshape(labels.shape[0]).long()
                hit = torch.argmax(pf, dim=-1) == lab
            else:
                hit = torch.argmax(pf, -1) == torch.argmax(labels, -1)
            out["correct"] = torch.sum(hit * mask).to(torch.int32)
        elif m == SPARSE_CATEGORICAL_CROSSENTROPY:
            lab = labels.reshape(labels.shape[0]).long()
            logp = torch.log_softmax(pf, dim=-1)
            out["scce"] = -torch.sum(
                torch.gather(logp, -1, lab[:, None])[:, 0] * mask)
        elif m == CATEGORICAL_CROSSENTROPY:
            out["cce"] = -torch.sum(
                torch.sum(labels * torch.log(pf + 1e-8), dim=-1) * mask)
        elif m == MEAN_SQUARED_ERROR:
            out["mse"] = torch.sum(_per_row_mean(torch.square(pf - labels))
                                   * mask)
        elif m == ROOT_MEAN_SQUARED_ERROR:
            out["rmse"] = torch.sum(torch.sqrt(
                _per_row_mean(torch.square(pf - labels))) * mask)
        elif m == MEAN_ABSOLUTE_ERROR:
            out["mae"] = torch.sum(_per_row_mean(torch.abs(pf - labels))
                                   * mask)
    return out
