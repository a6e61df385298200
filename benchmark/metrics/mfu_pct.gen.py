"""Model FLOP of the prompt tokens prefilled and the tokens generated in
the window (attention at each token's actual context, the vocabulary
head on every token that yields one) over the window, as a share of 989
TFLOP/s."""

from portbench.readers import mfu_pct as read  # noqa: F401
