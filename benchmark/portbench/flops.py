"""Operations and bytes of the work a configuration states.

A roofline share is the least time the chip could take for the work,
the larger of operations over the FLOP peak and bytes over the byte
peak, divided by the time the kernels took.  Each input byte counts once
when read and each output byte once when written, whatever a kernel
reads again.  The counts follow the configuration's shapes and dtypes,
never the implementation: a later kernel that does the same work in
another way is held to the same numbers.
"""

from __future__ import annotations

from typing import Dict

from . import peaks


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time of ``flop`` operations moving ``nbytes`` bytes on
    one H100 at its published peaks."""
    return max(flop / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """Query-key pairs one head of one sequence scores: every pair, or
    under a causal mask those with the key at or before the query (the
    queries are the last ``sq`` of ``sk`` positions)."""
    if not causal:
        return sq * sk
    return sum(sk - sq + i + 1 for i in range(sq))


def flash_forward(n: int, sq: int, h: int, d: int, sk: int = 0,
                  causal: bool = False, elt: int = 2) -> Dict[str, float]:
    """Attention forward over (n, s, h, d) operands of ``elt`` bytes:
    two products of 2 FLOP a multiply-add (QK^T and PV), q, k, v read,
    O written and the float32 row log-sum-exp written."""
    sk = sk or sq
    pairs = attention_pairs(sq, sk, causal)
    flop = 4.0 * n * h * pairs * d
    nbytes = (2 * n * sq * h * d + 2 * n * sk * h * d) * elt + n * h * sq * 4
    return {"flop": flop, "bytes": float(nbytes)}


def flash_backward(n: int, sq: int, h: int, d: int, sk: int = 0,
                   causal: bool = False, elt: int = 2) -> Dict[str, float]:
    """Attention backward: five products (the scores again, dV, dP, dQ
    and dK); q, k, v, O, dO and the log-sum-exp read, dq, dk, dv
    written."""
    sk = sk or sq
    pairs = attention_pairs(sq, sk, causal)
    flop = 10.0 * n * h * pairs * d
    nbytes = (4 * n * sq * h * d + 4 * n * sk * h * d) * elt + n * h * sq * 4
    return {"flop": flop, "bytes": float(nbytes)}


def layernorm_bytes(rows: int, d: int, in_bytes: int, out_bytes: int,
                    residual: bool = False) -> float:
    """A LayerNorm over ``rows`` rows of ``d``: the input (and a residual
    of the input's width) read, the output written, float32 scale and
    bias read.  Its operations (under 10 a value) are far below its bytes
    at the H100's ratio of peaks."""
    reads = in_bytes * (2 if residual else 1)
    return float(rows * d * (reads + out_bytes) + 2 * d * 4)


def layer_matmul_flop(geo: Dict[str, int]) -> float:
    """FLOP of one token through one transformer layer's products: the
    q, k, v and output projections and the two feed-forward products."""
    d, f = geo["d_model"], geo["d_ff"]
    return 2.0 * (4 * d * d + 2 * d * f)


def encoder_train_flop(geo: Dict[str, int], seq: int, samples: int) -> Dict:
    """Model FLOP of ``samples`` training samples of the encoder
    classifier at sequence ``seq``: every layer's products and its
    attention at the actual sequence length, the classifier on the
    [CLS] row; the backward pass twice the forward, nothing recomputed.
    ``matmul`` is the share in the Linear and projection products."""
    layers = geo["layers"]
    mm = layers * seq * layer_matmul_flop(geo) + 2.0 * geo["d_model"] * geo[
        "classes"]
    attn = layers * 4.0 * geo["heads"] * seq * seq * geo["head_dim"]
    return {"model": 3.0 * samples * (mm + attn), "matmul": 3.0 * samples * mm}


def lm_token_flop(geo: Dict[str, int], context: int, head: bool) -> float:
    """Forward FLOP of one token of the causal LM that attends to
    ``context`` positions (itself included), with the vocabulary head
    when its logits are needed (the last prompt token and every decoded
    token)."""
    f = geo["layers"] * (layer_matmul_flop(geo)
                         + 4.0 * geo["heads"] * context * geo["head_dim"])
    if head:
        f += 2.0 * geo["d_model"] * geo["vocab"]
    return f


def lm_prefill_flop(geo: Dict[str, int], prompt: int) -> float:
    """A whole prompt's prefill: token ``i`` attends to ``i + 1``
    positions; the head runs on the last token only."""
    per = geo["layers"] * layer_matmul_flop(geo)
    ctx = prompt * (prompt + 1) // 2
    attn = geo["layers"] * 4.0 * geo["heads"] * geo["head_dim"] * ctx
    return prompt * per + attn + 2.0 * geo["d_model"] * geo["vocab"]
