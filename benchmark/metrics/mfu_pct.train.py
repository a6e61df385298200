"""Model FLOP of the training samples completed in the window (forward,
and a backward of twice the forward; nothing recomputed; attention at the
cell's sequence length) over the window, as a share of 989 TFLOP/s."""

from portbench.readers import mfu_pct as read  # noqa: F401
