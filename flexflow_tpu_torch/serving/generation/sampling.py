"""Per-request sampling for token generation: the strategy
(:class:`SamplingParams`, :func:`filtered_probs`, as the JAX package's
``serving/generation/sampling.py`` defines them) and the draw.

The draw cannot reproduce ``jax.random``'s threefry bits.  It is a
Gumbel-max draw whose noise is a counter-based hash of (request seed,
global position of the token drawn, stream tag, vocabulary index),
computed with int64 tensor ops on whatever device holds the
probabilities: one launch sequence for every slot at once, no host
random state, and the same noise on the CPU and the card (a
``torch.Generator`` per request would be one launch per slot per step,
and its CPU and CUDA streams differ).  So a request replays the same
tokens for the same seed, and a slot's draw does not depend on which
other slots share its step.

Speculative decoding's acceptance (``speculative_accept``) is not
ported yet (ROADMAP A.10b).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # the finite mask value of ops.attention

# stream tags: one independent stream per kind of random decision at a
# (seed, position); speculative decoding's draft, accept and residual
# streams (1-3 in the JAX package) come with it
STREAM_MAIN = 0

_MASK32 = 0xFFFFFFFF
# odd multipliers below 2**31, so a product of a 32-bit value never
# leaves int64 (the first is lowbias32's, the second MurmurHash2's)
_M1 = 0x7FEB352D
_M2 = 0x5BD1E995
_SALT = 0x9E3779B9


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling strategy.  ``temperature <= 0`` is greedy
    argmax (the default); ``top_k <= 0`` keeps the whole vocabulary;
    ``top_p`` is the nucleus mass (1.0 = no cut).  ``seed`` roots the
    request's draws: sampling is deterministic per (seed, request)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def filtered_probs(logits, temperature, top_k, top_p) -> torch.Tensor:
    """Per-row temperature, then top-k, then top-p, normalised:
    ``logits`` (n, V) and (n,) strategy tensors -> float32 (n, V)
    probabilities.  Rows with ``temperature <= 0`` are the exact one-hot
    of ``argmax(logits)``; ties at the top-p cut value stay in."""
    logits = logits.to(torch.float32)
    v = logits.shape[-1]
    greedy = temperature <= 0.0
    t = torch.where(greedy, torch.ones_like(temperature), temperature)
    scaled = logits / t[:, None]
    # top-k: keep the k largest (k <= 0 keeps all)
    k = torch.where(top_k <= 0, torch.full_like(top_k, v), top_k)
    k = k.clamp(1, v).to(torch.int64)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = desc.gather(-1, (k - 1)[:, None])
    scaled = scaled.masked_fill(scaled < kth, NEG_INF)
    # top-p over the k survivors: the smallest prefix of the sorted
    # probabilities whose mass reaches top_p (the top one always kept)
    probs = torch.softmax(scaled, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    keep = (csum - sp) < top_p[:, None]
    cut = torch.where(keep, sp, torch.full_like(sp, float("inf"))
                      ).min(dim=-1).values
    scaled = scaled.masked_fill(probs < cut[:, None], NEG_INF)
    probs = torch.softmax(scaled, dim=-1)
    onehot = F.one_hot(logits.argmax(dim=-1), v).to(torch.float32)
    return torch.where(greedy[:, None], onehot, probs)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A bijective avalanche mix of the 32-bit values held in an int64
    tensor (xor-shifts and two odd multiplies, each product reduced mod
    2**32)."""
    h = h ^ (h >> 16)
    h = (h * _M1) & _MASK32
    h = h ^ (h >> 15)
    h = (h * _M2) & _MASK32
    return h ^ (h >> 16)


def uniform_01(seeds: torch.Tensor, positions: torch.Tensor, stream: int,
               vocab: int) -> torch.Tensor:
    """float64 (n, vocab) uniforms in (0, 1): entry (i, j) a fixed
    function of (seeds[i], positions[i], stream, j) with 53 random
    bits, on the device of ``seeds``."""
    i64 = torch.int64
    base = _mix32((seeds.to(i64) & _MASK32) ^ _SALT)
    base = _mix32(base ^ (positions.to(i64) & _MASK32))
    base = _mix32(base ^ int(stream))
    idx = torch.arange(vocab, device=seeds.device, dtype=i64)
    hi = _mix32(base[:, None] ^ idx[None, :])
    lo = _mix32(hi ^ _SALT)
    return ((hi * (1 << 21) + (lo >> 11)).to(torch.float64) + 0.5) \
        / float(1 << 53)


def categorical(probs: torch.Tensor, seeds: torch.Tensor,
                positions: torch.Tensor, stream: int = STREAM_MAIN
                ) -> torch.Tensor:
    """One draw per row of ``probs`` (n, V): the Gumbel-max argmax of
    ``log p + G`` with ``G = -log(-log(u))`` from :func:`uniform_01`.
    Zero-probability entries can never win; a one-hot row returns its
    index.  Returns int64 (n,)."""
    u = uniform_01(seeds, positions, stream, probs.shape[-1])
    p = probs.to(torch.float64)
    logp = torch.where(p > 0.0, torch.log(p),
                       torch.full_like(p, float("-inf")))
    return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)


__all__ = ["SamplingParams", "GREEDY", "STREAM_MAIN", "filtered_probs",
           "uniform_01", "categorical"]
