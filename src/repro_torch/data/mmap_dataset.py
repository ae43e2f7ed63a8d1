"""Memory-mapped token dataset, the production data path (counterpart of
`repro.data.mmap_dataset`).

File format: a flat little-endian int32 token file (MaxText/llm.c style) plus
a small JSON sidecar ({"vocab_size": V, "n_tokens": N}). Sequences are drawn
by deterministic strided addressing from (seed, stream), as the reference
draws them, so the pipeline's restart and sharding semantics match the
synthetic source's and both packages read the same windows. `batch` returns
numpy arrays, as `TokenTask.batch` does: the pipeline moves them to its
device.
"""
from __future__ import annotations

import json
import pathlib
from typing import Union

import numpy as np

PathLike = Union[str, pathlib.Path]


class MmapTokenDataset:
    def __init__(self, path: PathLike, seed: int = 0):
        path = pathlib.Path(path)
        meta = json.loads(path.with_suffix(".json").read_text())
        self.vocab_size = int(meta["vocab_size"])
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seed = seed

    def __len__(self) -> int:
        return len(self.tokens)

    def batch(self, n: int, seq_len: int, stream: int) -> dict:
        """Deterministic (seed, stream)-addressed batch of n sequences:
        tokens and their next tokens, (n, seq_len) int32 each."""
        usable = len(self.tokens) - seq_len - 1
        if usable <= 0:
            raise ValueError(f"token file of {len(self.tokens)} tokens is shorter than one "
                             f"sequence of {seq_len} + 1")
        rng = np.random.default_rng((self.seed, stream))
        starts = rng.integers(0, usable, size=n)
        window = self.tokens[starts[:, None] + np.arange(seq_len + 1)[None, :]]
        return {"tokens": window[:, :-1], "labels": window[:, 1:]}

    @staticmethod
    def write(path: PathLike, tokens: np.ndarray, vocab_size: int) -> None:
        """Write a dataset file and its sidecar."""
        path = pathlib.Path(path)
        tokens.astype(np.int32).tofile(path)
        path.with_suffix(".json").write_text(json.dumps(
            {"vocab_size": int(vocab_size), "n_tokens": int(tokens.size)}))
