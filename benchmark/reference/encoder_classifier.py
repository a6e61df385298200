"""Plain reference of the encoder classifier (BERT-base's widths in the
port's block): token and learned position embeddings, post-norm blocks
of self-attention and a GELU (tanh) feed forward, a classifier on the
first ([CLS]) position, mean cross-entropy, and Adam in the form the
configuration states.  Float32 with TF32 off; imports nothing of the
program.  Weights are named as the benchmark's weight spec names them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .common import embed, exact_float32, linear, post_norm_layer


def logits(w: Dict[str, torch.Tensor], geo: Dict, tokens: torch.Tensor,
           prec: str = "float32") -> torch.Tensor:
    t = embed(tokens, w, prec)
    for i in range(geo["layers"]):
        t = post_norm_layer(t, w, i, geo["heads"], geo["eps"], False, prec)
    return linear(t[:, 0], w["classifier/kernel"], w["classifier/bias"],
                  prec)


def loss(w, geo, tokens, labels, prec: str = "float32") -> torch.Tensor:
    return F.cross_entropy(logits(w, geo, tokens, prec),
                           labels.reshape(-1).long())


def train(w0: Dict[str, torch.Tensor], geo: Dict, opt: Dict,
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          prec: str = "float32") -> Dict:
    """Adam steps from ``w0``, one a batch.  Returns each step's loss,
    the first step's gradient norm by leaf, and the norm of each leaf's
    change over all the steps.  Adam as the configuration states it:
    ``alpha_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``, ``w -= alpha_t * m /
    (sqrt(v) + eps)``, with weight decay added to the gradient."""
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["epsilon"]
    wd = opt.get("weight_decay", 0.0)
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    with exact_float32():
        for t, (tokens, labels) in enumerate(batches, start=1):
            lv = loss(w, geo, tokens, labels, prec)
            grads = torch.autograd.grad(lv, list(w.values()))
            losses.append(float(lv.detach()))
            alpha = opt["lr"] * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            with torch.no_grad():
                for (k, p), g in zip(w.items(), grads):
                    if t == 1:
                        grad_norms[k] = float(g.norm())
                    g = g + wd * p
                    m[k].mul_(b1).add_((1 - b1) * g)
                    v2[k].mul_(b2).add_((1 - b2) * g * g)
                    p.sub_(alpha * m[k] / (v2[k].sqrt() + eps))
            del lv, grads
    with torch.no_grad():
        change = {k: float((w[k] - w0[k]).norm()) for k in w}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
