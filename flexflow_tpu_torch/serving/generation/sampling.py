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

Speculative decoding's acceptance is the JAX package's rule
(Leviathan-style): accept the draft token ``x ~ q`` when ``u * q(x) <=
p(x)``, keep the accepted prefix of the window, and at the first
rejection draw from the residual ``norm(max(p - q, 0))``.  The emitted
token's marginal is ``p``.  The draft's proposal, the accept uniform and
the residual draw at one position take stream tags of their own, so the
three are independent (the uniform must not be correlated with the
proposal it judges).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # the finite mask value of ops.attention

# stream tags: one independent stream per kind of random decision at a
# (seed, position of the token decided), the JAX package's numbering
STREAM_MAIN = 0      # plain sampled decode
STREAM_DRAFT = 1     # the draft's proposal
STREAM_ACCEPT = 2    # the accept/reject uniform
STREAM_RESIDUAL = 3  # the residual draw at the first rejected position

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


def residual_probs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The rejection residual ``norm(max(p - q, 0))`` per row; a row
    whose residual sums to 0 (p == q) falls back to ``p``, whose tokens
    were all accepted with probability 1, so the branch guards the
    arithmetic and never changes the marginal."""
    r = torch.clamp(p - q, min=0.0)
    rs = r.sum(dim=-1, keepdim=True)
    pos = rs > 0.0
    return torch.where(pos, r / torch.where(pos, rs, torch.ones_like(rs)),
                       p)


def accept_count(d: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """The accepted prefix of each window: ``d`` (n, W) proposals,
    ``p``/``q`` (n, W, V) target and draft probabilities at the same
    positions, ``u`` (n, W) uniforms.  Entry t is accepted when ``u *
    q(d) <= p(d)`` (no 0/0), and the count is the length of the run of
    accepts from the start (the cumulative product).  Returns int64
    (n,)."""
    pd = p.gather(-1, d[..., None].long())[..., 0]
    qd = q.gather(-1, d[..., None].long())[..., 0]
    accept = u.to(pd.dtype) * qd <= pd
    return torch.cumprod(accept.to(torch.int64), dim=-1).sum(dim=-1)


def accept_uniforms(seeds: torch.Tensor, positions: torch.Tensor
                    ) -> torch.Tensor:
    """The accept uniforms, float64 (n, W), keyed on each slot's seed
    and the position of the token each window entry decides
    (``positions`` (n, W)) on ``STREAM_ACCEPT``."""
    n, w = positions.shape
    return uniform_01(seeds.repeat_interleave(w), positions.reshape(-1),
                      STREAM_ACCEPT, 1).reshape(n, w)


def speculative_accept(d: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                       seeds: torch.Tensor, positions: torch.Tensor,
                       u=None):
    """Rejection-sampling acceptance over a verify window: ``d`` (n, W)
    proposals, ``p``/``q`` (n, W, V), ``seeds`` (n,) and ``positions``
    (n, W) the position of the token each entry decides.  Returns
    ``(n_accept (n,), out (n, W))``: ``out[:, :n]`` are the accepted
    proposals and ``out[:, n]`` (when n < W) the residual draw at the
    first rejected entry, keyed on its position on ``STREAM_RESIDUAL``
    (for a full accept the draw at index W-1 is made and discarded).
    ``u`` replaces the accept uniforms (:func:`accept_uniforms`) when
    given."""
    n, w, _ = p.shape
    if u is None:
        u = accept_uniforms(seeds, positions)
    n_acc = accept_count(d, p, q, u)
    idx = n_acc.clamp(max=w - 1)
    rows = torch.arange(n, device=p.device)
    c = categorical(residual_probs(p[rows, idx], q[rows, idx]), seeds,
                    positions[rows, idx], STREAM_RESIDUAL)
    out = torch.where(torch.arange(w, device=p.device)[None, :]
                      == n_acc[:, None], c[:, None], d.long())
    return n_acc, out


def speculative_sample(p: torch.Tensor, q: torch.Tensor, n: int,
                       seed: int = 0) -> torch.Tensor:
    """The single-position reference sampler for the property test:
    ``n`` independent tokens through draft -> accept -> residual with
    target ``p`` (V,) and draft ``q`` (V,), draw i keyed on (seed, i).
    Their distribution must be ``p``, the invariant the windowed
    :func:`speculative_accept` inherits position by position."""
    seeds = torch.full((n,), int(seed), dtype=torch.int64, device=p.device)
    pos = torch.arange(n, device=p.device)
    d = categorical(q.expand(n, -1), seeds, pos, STREAM_DRAFT)
    u = uniform_01(seeds, pos, STREAM_ACCEPT, 1)[:, 0]
    accept = u.to(p.dtype) * q[d] <= p[d]
    r = residual_probs(p[None], q[None])[0]
    c = categorical(r.expand(n, -1), seeds, pos, STREAM_RESIDUAL)
    return torch.where(accept, d, c)


__all__ = ["SamplingParams", "GREEDY", "STREAM_MAIN", "STREAM_DRAFT",
           "STREAM_ACCEPT", "STREAM_RESIDUAL", "filtered_probs",
           "uniform_01", "categorical", "residual_probs", "accept_count",
           "accept_uniforms", "speculative_accept", "speculative_sample"]
