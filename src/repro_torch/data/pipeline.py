"""Deterministic synthetic data pipelines (host-sharded, restartable): the
JAX package's `data/pipeline.py`.

Every batch is a pure numpy function of (seed, step, process_index), the
same function as in the JAX package, so the port's batches are bitwise the
JAX package's, restart from a checkpoint is exact, and each process
materializes only its slice of the global batch.  The iterators hand each
batch over as tensors on the device asked for.

  TokenPipeline    Zipf-ish synthetic LM tokens with a learnable
                   bigram-like structure (motifs), so loss can fall.
  MixturePipeline  Gaussian-mixture draws for the diffusion side (the
                   paper's toy data; the exact score is `sde.mixture`'s).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_process: int = 1
    process_index: int = 0
    prefetch: int = 2

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_process:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_process} processes")
        return self.global_batch // self.n_process

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) int32 of shape (local_batch, seq_len)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.process_index]))
        B, S, V = self.local_batch, self.seq_len, self.vocab
        base = rng.zipf(1.5, size=(B, S + 1)) % V
        motif = rng.integers(0, V, size=(B, 8))
        pos = np.arange(S + 1) % 8
        mix = rng.random((B, S + 1)) < 0.5
        stream = np.where(mix, motif[:, pos], base).astype(np.int32)
        return stream[:, :-1], stream[:, 1:]

    def iterator(self, start_step: int = 0,
                 device="cuda") -> Iterator[dict]:
        step = start_step
        while True:
            tokens, labels = self.batch_at(step)
            yield {"tokens": torch.from_numpy(tokens).to(device),
                   "labels": torch.from_numpy(labels).to(device),
                   "step": step}
            step += 1


@dataclasses.dataclass
class MixturePipeline:
    means: np.ndarray              # (M, *data_shape)
    stds: np.ndarray               # (M,)
    weights: np.ndarray            # (M,)
    global_batch: int
    seed: int = 0
    n_process: int = 1
    process_index: int = 0

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_process

    def batch_at(self, step: int) -> np.ndarray:
        """(local_batch, *data_shape) float32 draws."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.process_index]))
        w = np.asarray(self.weights, np.float64)
        w = w / w.sum()
        idx = rng.choice(len(w), size=self.local_batch, p=w)
        mu = np.asarray(self.means)[idx]
        sd = np.asarray(self.stds)[idx].reshape((-1,) + (1,) * (mu.ndim - 1))
        return (mu + sd * rng.standard_normal(mu.shape)).astype(np.float32)

    def iterator(self, start_step: int = 0,
                 device="cuda") -> Iterator[dict]:
        step = start_step
        while True:
            yield {"x0": torch.from_numpy(self.batch_at(step)).to(device),
                   "step": step}
            step += 1
