"""NMT and the LSTM language model, the topologies of
``flexflow_tpu/models/nmt.py`` (the reference's ``nmt/nmt.cc:31-84``):
source and target embeddings, a stacked LSTM encoder, a stacked LSTM
decoder seeded layer by layer with the encoder's final (h, c) (teacher
forcing on the target tokens), a vocab projection and a per-token
softmax."""

from __future__ import annotations

from typing import Tuple

from ..config import FFConfig
from ..model import FFModel
from ..tensor import Tensor


def build_nmt(config: FFConfig, vocab_size: int = 20000,
              embed_dim: int = 2048, hidden_dim: int = 2048,
              num_layers: int = 2, src_len: int = 24, tgt_len: int = 24,
              device=None
              ) -> Tuple[FFModel, Tuple[Tensor, Tensor], Tensor]:
    """Returns (model, (src_tokens, tgt_tokens), logits).  Labels are the
    (n, tgt_len) next-token ids."""
    ff = FFModel(config, device=device)
    n = config.batch_size
    src = ff.create_tensor((n, src_len), dtype="int32", name="src_tokens")
    tgt = ff.create_tensor((n, tgt_len), dtype="int32", name="tgt_tokens")
    enc = ff.embedding(src, vocab_size, embed_dim, aggr="none",
                       name="src_embedding")
    dec = ff.embedding(tgt, vocab_size, embed_dim, aggr="none",
                       name="tgt_embedding")
    states = []
    t = enc
    for i in range(num_layers):
        t, h, c = ff.lstm(t, hidden_dim, name=f"encoder_lstm_{i}")
        states.append((h, c))
    t = dec
    for i in range(num_layers):
        t, _, _ = ff.lstm(t, hidden_dim, initial_state=states[i],
                          name=f"decoder_lstm_{i}")
    logits = ff.dense(t, vocab_size, name="vocab_projection")
    ff.softmax(logits)
    return ff, (src, tgt), logits


def build_lstm_lm(config: FFConfig, vocab_size: int = 64,
                  embed_dim: int = 32, hidden_dim: int = 32,
                  num_layers: int = 1, seq_len: int = 32, device=None
                  ) -> Tuple[FFModel, Tensor, Tensor]:
    """Recurrent language model: embedding, stacked LSTM, per-token
    vocab softmax.  Labels are the (n, seq_len) next-token ids."""
    ff = FFModel(config, device=device)
    tokens = ff.create_tensor((config.batch_size, seq_len), dtype="int32",
                              name="tokens")
    t = ff.embedding(tokens, vocab_size, embed_dim, aggr="none",
                     name="tok_embedding")
    for i in range(num_layers):
        t, _, _ = ff.lstm(t, hidden_dim, name=f"lm_lstm_{i}")
    logits = ff.dense(t, vocab_size, name="vocab_projection")
    ff.softmax(logits)
    return ff, tokens, logits
