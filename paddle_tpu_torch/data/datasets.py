"""The synthetic IMDB reader and the sentiment classifier's batching
(counterpart of ``paddle_tpu/data/datasets.py``, its ``imdb`` and
``_rng``, and of ``collate`` in the ``imdb_real`` benchmark,
``benchmark/run_benchmarks.py:590-597``).

``imdb(data_dir=None)`` is the JAX reader's synthetic branch, line for line:
seeded numpy, so the same seed gives the same samples in both packages.
The real-corpus branch (``aclImdb_v1.tar.gz`` through the tar reader, the
word dict and the recordio loader) is not ported and raises.
"""

from __future__ import annotations

import numpy as np

#: the canonical IMDB word dict's size (reference imdb.word_dict() at
#: cutoff 150), the synthetic reader's default vocabulary
IMDB_VOCAB = 5148


def _rng(seed):
    return np.random.default_rng(seed)


def imdb(split="train", num_samples=1024, vocab_size=IMDB_VOCAB, max_len=100,
         seed=0, data_dir=None):
    """Reader of (word-id sequence list[int], label {0, 1}) samples: a
    length in [8, max_len), ids in [0, vocab_size // 2) for label 0 and in
    [vocab_size // 4, vocab_size) for label 1."""
    if data_dir is not None:
        raise NotImplementedError(
            "the real IMDB corpus (aclImdb_v1.tar.gz under data_dir) is not "
            "ported: pass data_dir=None for the synthetic reader")
    rng = _rng(seed if split == "train" else seed + 1)

    def reader():
        for _ in range(num_samples):
            label = int(rng.integers(0, 2))
            n = int(rng.integers(8, max_len))
            lo, hi = (0, vocab_size // 2) if label == 0 else \
                (vocab_size // 4, vocab_size)
            seq = rng.integers(lo, hi, n).astype(np.int64)
            yield list(seq), label
    return reader


def collate(samples, max_len):
    """(ids int32 [B, max_len] padded with 0 and cut at max_len, labels
    float32 [B])."""
    ids = np.zeros((len(samples), max_len), np.int32)
    labels = np.zeros((len(samples),), np.float32)
    for i, (seq, lab) in enumerate(samples):
        seq = seq[:max_len]
        ids[i, :len(seq)] = seq
        labels[i] = lab
    return ids, labels
