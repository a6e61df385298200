"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  Every roofline
and MFU of the benchmark divides by these; the card's power limit is
reported beside them in each result line."""

# bf16 / fp16 tensor-core peak, FLOP/s
BF16_FLOPS = 989e12
# HBM3 bandwidth, bytes/s
HBM_BYTES = 3.35e12
