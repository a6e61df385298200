"""Transformer encoder and causal LM, the topologies of
``flexflow_tpu/models/transformer.py``: token + learned position
embeddings, post-norm blocks (attention, add, LayerNorm, GELU FFN, add,
LayerNorm); the encoder classifies the first ([CLS]) token, the LM
predicts every next token."""

from __future__ import annotations

from typing import Tuple

from ..config import FFConfig
from ..model import FFModel
from ..tensor import Tensor


def build_transformer(config: FFConfig, num_layers: int = 4,
                      d_model: int = 512, num_heads: int = 8,
                      d_ff: int = 2048, seq_len: int = 128,
                      vocab_size: int = 32000, num_classes: int = 2,
                      dropout: float = 0.0, causal: bool = False,
                      device=None) -> Tuple[FFModel, Tensor, Tensor]:
    ff = FFModel(config, device=device)
    tokens = ff.create_tensor((config.batch_size, seq_len), dtype="int32",
                              name="tokens")
    t = ff.embedding(tokens, vocab_size, d_model, aggr="none",
                     name="tok_embedding")
    t = ff.position_embedding(t, max_len=seq_len)
    for i in range(num_layers):
        attn = ff.multihead_attention(t, num_heads=num_heads,
                                      dropout=dropout, causal=causal,
                                      name=f"attention_{i}")
        t = ff.layer_norm(ff.add(t, attn), name=f"ln_attn_{i}")
        h = ff.dense(t, d_ff, activation="gelu", name=f"ffn_up_{i}")
        if dropout > 0.0:
            h = ff.dropout(h, dropout)
        h = ff.dense(h, d_model, name=f"ffn_down_{i}")
        t = ff.layer_norm(ff.add(t, h), name=f"ln_ffn_{i}")
    # classifier on the first token ([CLS] convention)
    cls = ff.split(t, [1, seq_len - 1], axis=1, name="cls_split")[0]
    cls = ff.reshape(cls, (config.batch_size, d_model))
    logits = ff.dense(cls, num_classes, name="classifier")
    ff.softmax(logits)
    return ff, tokens, logits


def build_transformer_lm(config: FFConfig, num_layers: int = 2,
                         d_model: int = 64, num_heads: int = 4,
                         d_ff: int = 128, seq_len: int = 64,
                         vocab_size: int = 128, dropout: float = 0.0,
                         device=None) -> Tuple[FFModel, Tensor, Tensor]:
    """Causal decoder-only language model: labels are the (n, seq_len)
    next-token ids; the final output is (n, s, vocab)."""
    ff = FFModel(config, device=device)
    tokens = ff.create_tensor((config.batch_size, seq_len), dtype="int32",
                              name="tokens")
    t = ff.embedding(tokens, vocab_size, d_model, aggr="none",
                     name="tok_embedding")
    t = ff.position_embedding(t, max_len=seq_len)
    for i in range(num_layers):
        attn = ff.multihead_attention(t, num_heads=num_heads,
                                      dropout=dropout, causal=True,
                                      name=f"attention_{i}")
        t = ff.layer_norm(ff.add(t, attn), name=f"ln_attn_{i}")
        h = ff.dense(t, d_ff, activation="gelu", name=f"ffn_up_{i}")
        if dropout > 0.0:
            h = ff.dropout(h, dropout)
        h = ff.dense(h, d_model, name=f"ffn_down_{i}")
        t = ff.layer_norm(ff.add(t, h), name=f"ln_ffn_{i}")
    logits = ff.dense(t, vocab_size, name="lm_head")
    ff.softmax(logits)
    return ff, tokens, logits
