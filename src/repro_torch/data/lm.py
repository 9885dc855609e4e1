"""Synthetic LM token pipeline: deterministic markov-ish token streams with
enough structure that cross-entropy falls during training. Used by the
end-to-end multi-pod FL example and the ~100M-model training script.

A copy of the JAX package's ``data/lm.py`` (numpy only); the port's LM
serving path draws its prompts from it.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_token_batches(*, vocab: int, batch: int, seq_len: int,
                            seed: int = 0, n_patterns: int = 512,
                            pattern_len: int = 16) -> Iterator[dict]:
    """Yields {"tokens", "labels"} int32 (batch, seq_len) forever.

    Streams are concatenations of a fixed bank of patterns, so a model can
    reduce loss by memorising intra-pattern transitions.
    """
    rng = np.random.RandomState(seed)
    bank = rng.randint(0, vocab, size=(n_patterns, pattern_len)).astype(np.int32)
    while True:
        n_pat = seq_len // pattern_len + 2
        ids = rng.randint(0, n_patterns, size=(batch, n_pat))
        stream = bank[ids].reshape(batch, -1)
        toks = stream[:, :seq_len + 1]
        yield {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
