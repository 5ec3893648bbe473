"""Deterministic synthetic LM tokens, the port's copy of
``repro/data/synthetic.py:lm_tokens`` (numpy only, same numbers)."""

from __future__ import annotations

import numpy as np


def lm_tokens(n_seqs: int, seq_len: int, vocab: int, *, seed: int = 0,
              noise: float = 0.1) -> np.ndarray:
    """Next-token-predictable sequences: ``x[t+1] = (a * x[t] + b) mod
    vocab`` with probability ``1 - noise``, uniform otherwise; (a, b) fixed
    per stream. Returns int32 (n, seq_len + 1), to split into inputs and
    targets."""
    rng = np.random.default_rng(seed)
    a = int(rng.integers(2, max(3, vocab - 1))) | 1  # odd -> full-period-ish
    b = int(rng.integers(1, vocab))
    out = np.empty((n_seqs, seq_len + 1), np.int64)
    x = rng.integers(0, vocab, size=(n_seqs,))
    out[:, 0] = x
    for t in range(1, seq_len + 1):
        nxt = (a * out[:, t - 1] + b) % vocab
        flip = rng.random(n_seqs) < noise
        nxt = np.where(flip, rng.integers(0, vocab, size=(n_seqs,)), nxt)
        out[:, t] = nxt
    return out.astype(np.int32)
