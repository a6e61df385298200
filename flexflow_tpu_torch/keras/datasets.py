"""Dataset loaders, the port of ``flexflow_tpu/keras/datasets.py``
(reference ``python/flexflow/keras/datasets``: mnist/cifar10/reuters
download-and-cache loaders).

Nothing is downloaded: each loader reads the standard cached file layout
when present (``~/.keras/datasets`` or an explicit ``path``) and
otherwise falls back to a deterministic synthetic set with the real
shapes, with a loud warning on the ``ff`` logger — the reference's own
examples run on synthetic data when no dataset is passed (README.md:44).
The synthetic arrays are the JAX package's bit for bit: the same numpy
generators, seeds and draw order.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

_CACHE = os.path.expanduser("~/.keras/datasets")


def _warn_synth(name: str) -> None:
    """Loud fallback marker (VERDICT Weak#7: accuracy harnesses must not
    silently validate on synthetic data)."""
    from ..fflogger import get_logger
    get_logger("ff").warning(
        f"{name}: no cached dataset found — using DETERMINISTIC SYNTHETIC "
        f"data (class-separable); accuracy numbers do not reflect the real "
        f"dataset")


def _synth_images(n, shape, classes, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, (n,)).astype(np.int32)
    x = rng.random((n,) + shape, dtype=np.float32) * 0.3
    # one fixed random PATTERN per class (seed shared by train/test splits):
    # prototype-matching is linearly separable, so MLPs/CNNs fit in a few
    # epochs — a scalar brightness shift (10 intervals of one feature) is
    # not, and stalls the accuracy-callback harness
    proto = np.random.default_rng(1234).random((classes,) + shape,
                                               dtype=np.float32)
    x = np.clip(x + 0.7 * proto[y], 0.0, 1.0)
    return x, y


class mnist:
    @staticmethod
    def load_data(path: str = "mnist.npz", n_synth: int = 2048):
        full = path if os.path.isabs(path) else os.path.join(_CACHE, path)
        if os.path.exists(full):
            with np.load(full, allow_pickle=True) as f:
                return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
        _warn_synth("mnist")
        xtr, ytr = _synth_images(n_synth, (28, 28), 10, seed=0)
        xte, yte = _synth_images(n_synth // 4, (28, 28), 10, seed=1)
        return (np.uint8(xtr * 255), ytr), (np.uint8(xte * 255), yte)


class cifar10:
    @staticmethod
    def load_data(path: str = "cifar-10-batches-py", n_synth: int = 2048):
        """Reads the standard python-pickle CIFAR-10 batches when present
        (the reference's binary reader is flexflow_dataloader.cc:512-599)."""
        full = path if os.path.isabs(path) else os.path.join(_CACHE, path)
        if os.path.isdir(full):
            xs, ys = [], []
            for i in range(1, 6):
                with open(os.path.join(full, f"data_batch_{i}"), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(d[b"data"].reshape(-1, 3, 32, 32))
                ys.extend(d[b"labels"])
            xtr = np.concatenate(xs)
            ytr = np.asarray(ys, np.int32)
            with open(os.path.join(full, "test_batch"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xte = d[b"data"].reshape(-1, 3, 32, 32)
            yte = np.asarray(d[b"labels"], np.int32)
            return (xtr, ytr), (xte, yte)
        _warn_synth("cifar10")
        xtr, ytr = _synth_images(n_synth, (3, 32, 32), 10, seed=0)
        xte, yte = _synth_images(n_synth // 4, (3, 32, 32), 10, seed=1)
        return (np.uint8(xtr * 255), ytr), (np.uint8(xte * 255), yte)


class reuters:
    """Reuters newswire topic classification (reference
    python/flexflow/keras/datasets/reuters.py: cached ``reuters.npz`` of
    object arrays of word-id sequences).  Synthetic fallback generates
    class-dependent word distributions so a bag-of-words MLP can fit."""

    NUM_CLASSES = 46

    @staticmethod
    def load_data(path: str = "reuters.npz", num_words=None, skip_top=0,
                  maxlen=None, test_split: float = 0.2, seed: int = 113,
                  start_char=1, oov_char=2, index_from=3,
                  n_synth: int = 2048):
        full = path if os.path.isabs(path) else os.path.join(_CACHE, path)
        if os.path.exists(full):
            with np.load(full, allow_pickle=True) as f:
                xs, labels = f["x"], f["y"]
            rng = np.random.RandomState(seed)
            idx = np.arange(len(xs))
            rng.shuffle(idx)
            xs, labels = xs[idx], labels[idx]
            xs = [[start_char] + [w + index_from for w in x]
                  if start_char is not None
                  else [w + index_from for w in x] for x in xs]
        else:
            _warn_synth("reuters")
            rng = np.random.default_rng(seed)
            labels = rng.integers(0, reuters.NUM_CLASSES,
                                  (n_synth,)).astype(np.int32)
            vocab = num_words or 1000
            xs = []
            for y in labels:
                ln = int(rng.integers(16, 64))
                # each class draws from its own 32-word band -> separable
                base = index_from + (int(y) * 19) % max(1, vocab - 64)
                xs.append([start_char] + list(
                    rng.integers(base, min(vocab, base + 32), ln)))
        if maxlen:
            keep = [(x, y) for x, y in zip(xs, labels) if len(x) < maxlen]
            xs, labels = [x for x, _ in keep], np.asarray(
                [y for _, y in keep])
        if not num_words:
            num_words = max(max(x) for x in xs)
        if oov_char is not None:
            xs = [[w if skip_top <= w < num_words else oov_char for w in x]
                  for x in xs]
        else:
            xs = [[w for w in x if skip_top <= w < num_words] for x in xs]
        cut = int(len(xs) * (1 - test_split))
        xs = np.asarray(xs, dtype=object)
        labels = np.asarray(labels, np.int32)
        return ((xs[:cut], labels[:cut]), (xs[cut:], labels[cut:]))
