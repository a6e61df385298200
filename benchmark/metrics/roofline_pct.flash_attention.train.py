"""Flash attention's share of its roofline in the training window: for
each forward and backward launch the least time of (batch, sequence,
heads, head dim) attention in the compute dtype, the larger of its FLOP
bound and its byte bound, over the device time of the kernels."""

from portbench import flops
from portbench.readers import FLASH_COUNTERS as KERNELS  # noqa: F401
from portbench.readers import FLASH_KERNELS, compute_bytes, share


def read(run):
    tr = run.trace
    if tr is None:
        return None
    g, t = run.cell.geometry, run.cell.traffic
    shape = (t["batch"], t["seq_len"], g["heads"], g["head_dim"])
    elt = compute_bytes(run)
    fwd = tr.kernel_count(r"flash_fwd")
    bwd = tr.kernel_count(r"flash_bwd") / 3
    f = flops.flash_forward(*shape, elt=elt)
    b = flops.flash_backward(*shape, elt=elt)
    least = (fwd * flops.least_seconds(f["flop"], f["bytes"])
             + bwd * flops.least_seconds(b["flop"], b["bytes"]))
    return share(least, tr.kernel_seconds(FLASH_KERNELS))
