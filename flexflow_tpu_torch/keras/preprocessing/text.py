"""Text preprocessing (reference keras/preprocessing/text.py — a
keras_preprocessing re-export; the subset the workloads use is
implemented natively with matching signatures)."""

from __future__ import annotations

import collections

import numpy as np

_FILTERS = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n'


def text_to_word_sequence(text, filters=_FILTERS, lower=True, split=" "):
    if lower:
        text = text.lower()
    table = str.maketrans({c: split for c in filters})
    return [w for w in text.translate(table).split(split) if w]


def one_hot(text, n, filters=_FILTERS, lower=True, split=" "):
    """Hash each word into [1, n) (keras semantics: index 0 reserved).
    crc32, not hash(): str hashing is salted per-process and would break
    encode/train/restore round trips across interpreter runs."""
    import zlib
    words = text_to_word_sequence(text, filters, lower, split)
    return [1 + (zlib.crc32(w.encode()) % (n - 1)) for w in words]


class Tokenizer:
    """Word-level tokenizer: fit_on_texts / texts_to_sequences /
    sequences_to_matrix, the surface seq_reuters_mlp.py drives."""

    def __init__(self, num_words=None, filters=_FILTERS, lower=True,
                 split=" ", oov_token=None):
        self.num_words = num_words
        self.filters, self.lower, self.split = filters, lower, split
        self.oov_token = oov_token
        self.word_counts: collections.OrderedDict = collections.OrderedDict()
        self.word_index: dict = {}
        self.index_word: dict = {}
        self.document_count = 0

    def fit_on_texts(self, texts):
        for text in texts:
            self.document_count += 1
            seq = (text if isinstance(text, (list, tuple))
                   else text_to_word_sequence(text, self.filters, self.lower,
                                              self.split))
            for w in seq:
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
        sorted_words = [w for w, _ in sorted(self.word_counts.items(),
                                             key=lambda kv: -kv[1])]
        if self.oov_token is not None:
            sorted_words = [self.oov_token] + sorted_words
        self.word_index = {w: i + 1 for i, w in enumerate(sorted_words)}
        self.index_word = {i: w for w, i in self.word_index.items()}

    def texts_to_sequences(self, texts):
        out = []
        nw = self.num_words
        oov = self.word_index.get(self.oov_token) if self.oov_token else None
        for text in texts:
            seq = (text if isinstance(text, (list, tuple))
                   else text_to_word_sequence(text, self.filters, self.lower,
                                              self.split))
            vect = []
            for w in seq:
                i = self.word_index.get(w)
                if i is None or (nw and i >= nw):
                    if oov is not None:
                        vect.append(oov)
                else:
                    vect.append(i)
            out.append(vect)
        return out

    def sequences_to_matrix(self, sequences, mode="binary"):
        """The reuters MLP's vectorizer: (n, num_words) bag-of-words."""
        if not self.num_words:
            raise ValueError("specify num_words to use sequences_to_matrix")
        n = len(sequences)
        m = np.zeros((n, self.num_words), np.float32)
        for i, seq in enumerate(sequences):
            counts = collections.Counter(j for j in seq if j < self.num_words)
            for j, c in counts.items():
                if mode == "count":
                    m[i, j] = c
                elif mode == "freq":
                    m[i, j] = c / max(1, len(seq))
                else:  # binary
                    m[i, j] = 1.0
        return m
