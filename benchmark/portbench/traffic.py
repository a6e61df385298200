"""The one traffic generator: every mix is a data file of parameters in
``traffic/``, read here.

Seeds change the order of the work, not its amount.  Sizes are drawn as
stratified quantiles of the mix's distribution, ``block`` at a time:
every block holds the same set of (prompt length, output length,
prefix) requests, paired once for every seed, in an order the seed
draws.  Requests are taken from one sequence by whichever client is
free, so any two seeds have sent the same sizes, block for block.  Token
ids and the order come from the seed.

Keys of a generation mix (``"kind": "generate"``)::

    "prompt", "output": a length distribution (below)
    "max_total": prompt + output at most this (the output is cut)
    "block": requests per stratified block (default 64)
    "arrival": {"kind": "closed", "clients": N, "ramp_s": r}
                                  the clients' first sends spread over r s
             | {"kind": "poisson", "rate": r}            requests/s
             | {"kind": "gamma", "rate": r, "cv": c}     bursty
    "shared_prefix": {"count": K, "length": L, "zipf": a}   optional:
        each prompt is one of K seeded prefixes of L tokens, picked by
        Zipf(a) popularity in stratified proportions, then a user turn
        drawn from "prompt"
    "warmup_s": seconds the loop runs before the window opens
    "check_tokens": served tokens the correctness sample reaches

A length distribution is ``{"dist": "lognormal", "median": m, "sigma":
s, "min": a, "max": b}``, ``{"dist": "uniform", "min": a, "max": b}``
(inclusive) or ``{"dist": "fixed", "value": v}``.

A training mix (``"kind": "train"``) gives ``batch``, ``seq_len`` and
``pool``, the number of distinct batches the window cycles through.
"""

from __future__ import annotations

import hashlib
import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed`` (any
    whole number, of any size or sign)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag))


def quantile_lengths(dist: Dict, n: int) -> np.ndarray:
    """``n`` stratified lengths of ``dist``: its quantiles at
    ``(i + 0.5) / n``, rounded and clipped to its range."""
    q = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    lo, hi = int(dist["min"]), int(dist["max"])
    if kind == "uniform":
        x = lo + np.floor(q * (hi - lo + 1))
    elif kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(v)) for v in q])
        x = np.rint(float(dist["median"]) * np.exp(float(dist["sigma"]) * z))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def apportion(weights: np.ndarray, n: int) -> np.ndarray:
    """``n`` split in proportion to ``weights`` by largest remainders."""
    share = weights / weights.sum() * n
    out = np.floor(share).astype(np.int64)
    for i in np.argsort(-(share - out), kind="stable")[: n - out.sum()]:
        out[i] += 1
    return out


class RequestSource:
    """The mix's requests in order: ``next()`` gives ``(prompt ids,
    output tokens)``."""

    def __init__(self, traffic: Dict, seed: int, vocab: int):
        self.vocab = int(vocab)
        self.block = int(traffic.get("block", 64))
        self.max_total = int(traffic["max_total"])
        prompts = quantile_lengths(traffic["prompt"], self.block)
        outputs = quantile_lengths(traffic["output"], self.block)
        # the pairing is the mix's, the same for every seed
        pairing = np.random.default_rng(0)
        outputs = pairing.permutation(outputs)
        self.rng = rng(seed, "requests")
        self.prefixes: List[np.ndarray] = []
        sp = traffic.get("shared_prefix")
        if sp:
            prng = rng(seed, "prefixes")
            self.prefixes = [prng.integers(0, self.vocab, int(sp["length"]),
                                           dtype=np.int64).astype(np.int32)
                             for _ in range(int(sp["count"]))]
            ranks = np.arange(1, len(self.prefixes) + 1, dtype=np.float64)
            counts = apportion(ranks ** -float(sp["zipf"]), self.block)
            prefix = pairing.permutation(np.repeat(
                np.arange(len(self.prefixes)), counts))
        else:
            prefix = np.full(self.block, -1)
        self.requests = list(zip(prompts.tolist(), outputs.tolist(),
                                 prefix.tolist()))
        self._queue: List[Tuple[int, int, int]] = []

    def _refill(self) -> None:
        order = self.rng.permutation(len(self.requests))
        self._queue = [self.requests[i] for i in order[::-1]]

    def next(self) -> Tuple[np.ndarray, int]:
        if not self._queue:
            self._refill()
        plen, out, k = self._queue.pop()
        turn = self.rng.integers(0, self.vocab, plen,
                                 dtype=np.int64).astype(np.int32)
        prompt = turn if k < 0 else np.concatenate([self.prefixes[k], turn])
        out = max(1, min(out, self.max_total - prompt.size))
        return prompt, out


def arrival_gaps(arrival: Dict, seed: int, n: int) -> np.ndarray:
    """Open-loop gaps between sends: stratified quantiles of the
    exponential (``poisson``) or of a gamma with coefficient of variation
    ``cv`` (``gamma``, bursts as BurstGPT fits them), at mean ``1 /
    rate``, in a seeded order."""
    mean = 1.0 / float(arrival["rate"])
    q = (np.arange(n) + 0.5) / n
    if arrival["kind"] == "poisson":
        x = -np.log1p(-q) * mean
    elif arrival["kind"] == "gamma":
        shape = 1.0 / float(arrival["cv"]) ** 2
        x = _gamma_quantiles(shape, q) * mean / shape
    else:
        raise ValueError(f"unknown open arrival {arrival['kind']!r}")
    return rng(seed, "arrivals").permutation(x)


def _gamma_quantiles(shape: float, q: np.ndarray) -> np.ndarray:
    """Quantiles of Gamma(shape, 1) by bisection on its CDF, computed by
    the regularised incomplete gamma series (numpy alone)."""
    def cdf(x: float) -> float:
        if x <= 0:
            return 0.0
        term = total = 1.0 / shape
        k = shape
        while term > 1e-12 * total:
            k += 1.0
            term *= x / k
            total += term
        return total * math.exp(-x + shape * math.log(x)
                                - math.lgamma(shape))

    out = []
    for p in q:
        lo, hi = 0.0, max(1.0, shape) * 50.0
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if cdf(mid) < p else (lo, mid)
        out.append(0.5 * (lo + hi))
    return np.asarray(out)
