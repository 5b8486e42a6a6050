"""Deterministic synthetic LM data (counterpart of ``repro.data.synthetic``).

A hash-based token stream, numpy only: the same ``(seed, step, row)``
gives the same tokens as the reference, so the port and the JAX package
train on identical batches.  The stream has learnable structure (token
t+1 depends on token t), so a few steps show a falling loss.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["SyntheticLM", "host_batch"]


def _hash2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Deterministic 32-bit mix of two uint32 arrays."""
    x = (a.astype(np.uint64) * np.uint64(2654435761)
         + b.astype(np.uint64) * np.uint64(40503)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(2246822519)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(13)
    return x.astype(np.uint32)


class SyntheticLM:
    """Markov-ish synthetic stream: next token = f(current, position)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed

    def sequence(self, step: int, row: int) -> np.ndarray:
        """One [seq_len + 1] token row, deterministic in (step, row)."""
        rid = np.uint32(step * self.batch + row + self.seed * 1_000_003)
        toks = np.empty(self.seq + 1, dtype=np.int32)
        toks[0] = int(_hash2(np.asarray(rid), np.asarray(np.uint32(0)))) % self.vocab
        # learnable structure: t+1 = (a * t + hash(pos)) % V with small noise
        pos_noise = _hash2(np.full(self.seq, rid), np.arange(self.seq, dtype=np.uint32))
        for i in range(self.seq):
            nxt = (toks[i] * 31 + 7 + int(pos_noise[i] % 13 == 0)) % self.vocab
            toks[i + 1] = nxt
        return toks

    def batch_rows(self, step: int, rows: np.ndarray) -> Dict[str, np.ndarray]:
        seqs = np.stack([self.sequence(step, int(r)) for r in rows])
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}


def host_batch(ds: SyntheticLM, step: int) -> Dict[str, np.ndarray]:
    """Full global batch on one host (single-process testing path)."""
    return ds.batch_rows(step, np.arange(ds.batch))
