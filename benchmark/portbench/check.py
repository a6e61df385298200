"""The numbers that decide ``correct``: what the timed path produced,
held against the plain reference.

Training: each checked step's loss, the first gradient as the optimizer
got it and the parameters' change over the checked steps, the last two
by the worst leaf: the gap between the program's norm of a leaf and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf.  Leaves whose reference gradient is under a thousandth
of the median leaf's are left out (a rule on the reference's gradient,
not a list of names: they move under Adam by round-off alone).

Generation: the widest gap by which a served token's reference logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

# a leaf whose reference gradient norm is below this share of the
# median leaf's is left out of the leaf comparisons
QUIET_LEAF = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Sequence[str]) -> List[float]:
    """Each kept leaf's gap: the program's norm against the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf."""
    med = statistics.median(ref[k] for k in keep)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep]


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Sequence[str]) -> float:
    return max(leaf_gaps(prog, ref, keep))


def median_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keep: Sequence[str]) -> float:
    return statistics.median(leaf_gaps(prog, ref, keep))


def kept_leaves(ref_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grads.values())
    return sorted(k for k, v in ref_grads.items() if v >= QUIET_LEAF * med)


def train_numbers(prog: Dict, ref: Dict, plain: Dict) -> Dict[str, float]:
    """The gaps of ``prog`` from the float32 reference ``ref``, and each
    over the same gap of ``plain``, the reference's steps with bf16
    products (``*_ratio``): all three as the reference's ``train``
    returns them.  A step's gradient is a sum over the batch whose terms
    cancel by an amount the seed's batch sets, and that scales every gap
    of a seed alike; the ratio divides it out."""
    out = train_gaps(prog, ref)
    floor = train_gaps(plain, ref)
    for k in list(out):
        out[k.replace("_gap", "_ratio")] = out[k] / max(floor[k], 1e-12)
    return out


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    keep = kept_leaves(ref["grad_norms"])
    loss = max(abs(p - r) / abs(r)
               for p, r in zip(prog["losses"], ref["losses"]))
    pl, rl = prog["losses"][0], ref["losses"][0]
    return {"loss_gap": loss,
            "first_loss_gap": abs(pl - rl) / abs(rl),
            "grad_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"],
                                   keep),
            "change_gap": worst_leaf(prog["change_norms"],
                                     ref["change_norms"], keep),
            "grad_median_gap": median_leaf(prog["grad_norms"],
                                           ref["grad_norms"], keep),
            "change_median_gap": median_leaf(prog["change_norms"],
                                             ref["change_norms"], keep)}


def logit_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap ``max(logits) - logits[token]`` over positions:
    ``ref_logits`` (k, vocab) at the k positions that produced
    ``tokens`` (k,)."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens.long()[:, None])[:, 0]
    return float((best - got).max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
