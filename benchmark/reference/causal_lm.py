"""Plain reference of the causal LM (GPT-2 small's widths in the port's
block): token and learned position embeddings, post-norm blocks of
causal self-attention and a GELU (tanh) feed forward, an untied
vocabulary head with no final LayerNorm.  One full forward over a whole
sequence, no cache.  Float32 with TF32 off; imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict

import torch

from .common import embed, exact_float32, linear, post_norm_layer


@torch.no_grad()
def logits(w: Dict[str, torch.Tensor], geo: Dict, tokens: torch.Tensor,
           prec: str = "float32") -> torch.Tensor:
    """(L, vocab) float32 logits of every position of the 1-D
    ``tokens``."""
    with exact_float32():
        t = embed(tokens[None], w, prec)
        for i in range(geo["layers"]):
            t = post_norm_layer(t, w, i, geo["heads"], geo["eps"], True,
                                prec)
        return linear(t[0], w["lm_head/kernel"], w["lm_head/bias"], prec)
