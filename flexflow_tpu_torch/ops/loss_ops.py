"""Op-form MSELoss, the counterpart of ``flexflow_tpu/ops/loss_ops.py``
(the reference's ``FFModel::mse_loss``, which DLRM and CANDLE-Uno end
in): an identity op in the forward graph that registers the model's
loss (``FFModel.mse_loss``), so the train step computes the MSE and its
metric sums."""

from __future__ import annotations

from ..op import Op, OpContext, OpType


class MSELoss(Op):
    op_type = OpType.MSELOSS

    def __init__(self, name, logits, reduction="average"):
        super().__init__(name, [logits])
        if reduction not in ("average", "sum"):
            raise ValueError(f"reduction must be 'average' or 'sum', got "
                             f"{reduction!r}")
        self.reduction = reduction
        self._add_output(logits.shape, logits.dtype)

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0]]

    def flops(self):
        return 3 * self.outputs[0].volume
