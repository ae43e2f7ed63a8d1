"""Shard-aware training data pipeline with a checkpointable cursor
(counterpart of `repro.data.pipeline`).

The pipeline yields batches {"tokens", "labels", "ascent": {...}} as tensors
on its device, bit-identical to the reference's for the same config: the same
`TokenTask` draws under the same stream ids (step, rank, lane), descent lane
0 and ascent lane 1. Ported:

* sharding: each data-parallel rank draws a disjoint stream, so the global
  batch is a partition, not a replica;
* the AsyncSAM ascent sub-batch: b' fresh samples per step (paper §3.3) under
  the "ascent" key, so methods never slice the descent batch;
* restartability: `state()` / `restore()` capture the step cursor;
* a worker thread that synthesizes (or reads) the next batches
  (`prefetch`) while the device steps; batches are moved to the device as
  they are handed out;
* the source: the synthetic `TokenTask` by default, or any object with the
  same `batch(n, seq_len, stream)` (`MmapTokenDataset`, a token file).

* the modality-stub inputs (`_family_extras`): a vlm model's precomputed
  patch embeddings and an audio model's frame embeddings, standard normal
  from the stream's own numpy generator, in the compute dtype, as the
  reference draws them.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.data.synthetic import TokenTask
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class PipelineConfig:
    global_batch: int
    seq_len: int
    ascent_fraction: float = 0.0    # b'/b; 0 disables the ascent sub-batch
    seed: int = 0
    rank: int = 0                   # data-parallel rank (multi-host)
    world: int = 1
    prefetch: int = 2


class TokenPipeline:
    """LM pipeline on `device` (default the card) over `source`: the
    synthetic `TokenTask` of the config's vocabulary and the pipeline's seed
    when None, or e.g. a `MmapTokenDataset`."""

    def __init__(self, cfg: ModelConfig, pcfg: PipelineConfig,
                 device: Union[str, torch.device] = "cuda", source: Optional[object] = None):
        if pcfg.global_batch % pcfg.world != 0:
            raise ValueError(f"global batch {pcfg.global_batch} does not split over "
                             f"{pcfg.world} ranks")
        self.cfg = cfg
        self.pcfg = pcfg
        self.device = torch.device(device)
        self.source = (source if source is not None
                       else TokenTask(vocab_size=cfg.vocab_size, seed=pcfg.seed))
        self._step = 0
        self._local_batch = pcfg.global_batch // pcfg.world
        b_asc = max(1, round(pcfg.global_batch * pcfg.ascent_fraction))
        self._local_ascent = max(1, b_asc // pcfg.world) if pcfg.ascent_fraction else 0

    # --- checkpointable cursor ------------------------------------------------
    def state(self) -> dict:
        return {"step": self._step, "seed": self.pcfg.seed,
                "rank": self.pcfg.rank, "world": self.pcfg.world}

    def restore(self, state: dict) -> None:
        if state["seed"] != self.pcfg.seed:
            raise ValueError("pipeline seed changed across restart")
        if "rank" in state and (state["rank"], state["world"]) != (self.pcfg.rank,
                                                                    self.pcfg.world):
            raise ValueError(f"pipeline identity changed across restart: checkpoint is "
                             f"rank {state['rank']}/{state['world']}, this pipeline is "
                             f"rank {self.pcfg.rank}/{self.pcfg.world}")
        self._step = int(state["step"])

    def peek(self) -> dict:
        """The next batch WITHOUT advancing the cursor."""
        return self._to_device(self._make(self._step))

    # --- batch synthesis -------------------------------------------------------
    @property
    def seq_len(self) -> int:
        return self.pcfg.seq_len

    def _make(self, step: int) -> dict:
        """Numpy batch of `step`; stream ids (step, rank, lane)."""
        stream = step * 2 * self.pcfg.world + 2 * self.pcfg.rank
        batch = self._one(self._local_batch, stream)
        if self._local_ascent:
            batch["ascent"] = self._one(self._local_ascent, stream + 1)
        return batch

    def _one(self, n: int, stream: int) -> dict:
        return {**self.source.batch(n, self.seq_len, stream),
                **_family_extras(self.cfg, n, self.seq_len, stream)}

    def _to_device(self, batch: dict) -> dict:
        cdt = getattr(torch, self.cfg.compute_dtype)
        return {k: self._to_device(v) if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device, dtype=cdt if k in _EXTRAS else None)
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        if self.pcfg.prefetch <= 0:
            while True:
                batch = self._make(self._step)
                self._step += 1
                yield self._to_device(batch)
        else:
            yield from self._prefetching()

    def _prefetching(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.pcfg.prefetch)
        stop = threading.Event()

        def worker(start_step: int):
            s = start_step
            while not stop.is_set():
                batch = self._make(s)        # synthesize once ...
                while not stop.is_set():
                    try:
                        q.put((s, batch), timeout=0.2)
                        s += 1
                        break                # ... retry only the hand-off
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, args=(self._step,), daemon=True)
        t.start()
        try:
            while True:
                s, batch = q.get()
                self._step = s + 1
                yield self._to_device(batch)
        finally:
            stop.set()
            try:                              # wake a blocked put()
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)


_EXTRAS = ("patch_embeds", "enc_frames")


def _family_extras(cfg: ModelConfig, n: int, s: int, stream: int) -> dict:
    """Modality-stub inputs (precomputed embeddings) as float32 numpy arrays,
    drawn as the reference's; `_to_device` casts them to the compute dtype,
    as the reference's `jnp.asarray(..., dtype=compute_dtype)` does."""
    from repro_torch.models.registry import stub_shapes
    rng = np.random.default_rng((stream, 99))
    return {name: rng.normal(size=shape).astype(np.float32)
            for name, shape in stub_shapes(cfg, n, s).items()}
