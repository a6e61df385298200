"""The matrix products' share of the bf16 peak in the training window:
the FLOP of every Linear and attention projection of the steps completed
(forward, and the backward's two products of each), at 989 TFLOP/s, over
the device time of the cuBLAS GEMM kernels.  The bound is the FLOP one:
at these shapes the operands' bytes take a few percent of it."""

from portbench import flops, peaks
from portbench.readers import GEMM_KERNELS, share


def read(run):
    tr, w = run.trace, run.work
    if tr is None or not w.get("samples"):
        return None
    mm = flops.encoder_train_flop(run.cell.geometry, w["seq_len"],
                                  w["samples"])["matmul"]
    return share(mm / peaks.BF16_FLOPS, tr.kernel_seconds(GEMM_KERNELS))
