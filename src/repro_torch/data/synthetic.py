"""Deterministic synthetic datasets (counterpart of `repro.data.synthetic`).

Numpy copies of the reference's two families, drawing bit-identical data for
the same seed and stream, so the port and the JAX package can be fed the same
inputs:
* `TokenTask`, an LM stream with learnable structure; `batch` returns numpy
  arrays, which the pipeline moves to its device;
* `ClassificationTask`, the paper's CIFAR-style benchmarks at small scale;
  `train_batches` and `valid_set` return tensors on the `device` given.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Union

import numpy as np
import torch


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


@dataclasses.dataclass(frozen=True)
class ClassificationTask:
    """Nonlinear Gaussian-cluster classification (CIFAR stand-in at small
    scale).

    Training draws from a FINITE pool (train_pool samples, cycled over
    epochs) with `label_noise` flipped labels, while validation is clean and
    unlimited: the regime where sharpness-aware methods earn their gap (cf.
    paper Table 4.1)."""
    n_classes: int = 10
    dim: int = 64
    depth: int = 2              # random-MLP warps applied to the clusters
    margin: float = 1.2         # cluster separation (lower = harder)
    noise: float = 1.0
    seed: int = 0
    train_pool: int = 1024      # finite training set size
    label_noise: float = 0.15   # fraction of flipped training labels

    VALID_STREAM = 10**9        # train streams must stay below this

    def _make(self, n: int, stream: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, stream))
        labels = rng.integers(0, self.n_classes, size=n)
        centers_rng = np.random.default_rng(self.seed)  # shared across streams
        centers = centers_rng.normal(size=(self.n_classes, self.dim)) * self.margin
        x = centers[labels] + rng.normal(size=(n, self.dim)) * self.noise
        for _ in range(self.depth):
            w = centers_rng.normal(size=(self.dim, self.dim)) / np.sqrt(self.dim)
            x = np.tanh(x @ w) + x * 0.5
        return x.astype(np.float32), labels.astype(np.int32)

    def _train_pool(self) -> tuple[np.ndarray, np.ndarray]:
        x, y = self._make(self.train_pool, stream=1)
        if self.label_noise > 0:
            rng = np.random.default_rng((self.seed, 2))
            flip = rng.random(self.train_pool) < self.label_noise
            y = np.where(flip, rng.integers(0, self.n_classes, size=self.train_pool), y)
        return x, y.astype(np.int32)

    def train_batches(self, batch_size: int, n_batches: int, start: int = 0,
                      device: Union[str, torch.device] = "cuda") -> Iterator[dict]:
        x, y = self._train_pool()
        rng = np.random.default_rng((self.seed, 3, start))
        for _ in range(n_batches):
            idx = rng.integers(0, self.train_pool, size=batch_size)
            yield {"x": torch.from_numpy(x[idx]).to(device),
                   "y": torch.from_numpy(y[idx]).to(device)}

    def valid_set(self, n: int = 2048, device: Union[str, torch.device] = "cuda") -> dict:
        x, y = self._make(n, stream=self.VALID_STREAM)
        return {"x": torch.from_numpy(x).to(device), "y": torch.from_numpy(y).to(device)}
