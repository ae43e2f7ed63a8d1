"""Deterministic synthetic token stream (counterpart of `TokenTask` in
`repro.data.synthetic`).

A numpy-only copy: `sample` draws bit-identical tokens to the reference's for
the same (vocab_size, seed, stream), so the port and the JAX package can be
fed the same requests. `batch` returns numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenTask:
    vocab_size: int
    seed: int = 0
    order_states: int = 64     # latent states of the generating chain

    def _tables(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        # latent-state transition and emission tables (peaked => learnable)
        trans = rng.dirichlet(np.full(self.order_states, 0.1),
                              size=self.order_states)
        emit = rng.dirichlet(np.full(self.vocab_size, 0.05),
                             size=self.order_states)
        return trans, emit

    def sample(self, n_seqs: int, seq_len: int, stream: int = 0) -> np.ndarray:
        """(n_seqs, seq_len) int32 tokens; `stream` selects a disjoint draw.

        Vectorized inverse-CDF sampling; vocabularies beyond 4096 fall back to
        uniform tokens."""
        rng = np.random.default_rng((self.seed, stream, 7))
        if self.vocab_size > 4096:
            return rng.integers(0, self.vocab_size,
                                size=(n_seqs, seq_len)).astype(np.int32)
        trans, emit = self._tables()
        trans_cdf = np.cumsum(trans, axis=-1)
        emit_cdf = np.cumsum(emit, axis=-1)
        state = rng.integers(0, self.order_states, size=n_seqs)
        out = np.empty((n_seqs, seq_len), np.int32)
        u_tok = rng.random((seq_len, n_seqs, 1))
        u_st = rng.random((seq_len, n_seqs, 1))
        for t in range(seq_len):
            out[:, t] = (emit_cdf[state] < u_tok[t]).sum(-1)
            state = (trans_cdf[state] < u_st[t]).sum(-1)
        return np.clip(out, 0, self.vocab_size - 1)

    def batch(self, n_seqs: int, seq_len: int, stream: int = 0) -> dict:
        tokens = self.sample(n_seqs, seq_len, stream)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        return {"tokens": tokens, "labels": labels}
