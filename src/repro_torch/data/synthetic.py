"""Deterministic synthetic LM data (counterpart of ``repro.data.synthetic``).

A hash-based token stream, numpy only: the same ``(seed, step, row)``
gives the same tokens as the reference, so the port and the JAX package
train on identical batches.  The stream has learnable structure (token
t+1 depends on token t), so a few steps show a falling loss.

:func:`make_global_batch` is the reference's sharded batch on the virtual
mesh: each virtual rank materialises the block its mesh slot's index
selects (rows over the batch axes, replicated over the rest), as each
JAX device materialises its addressable shard.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLM", "batches", "host_batch", "make_global_batch"]


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


def _block(axes, coords: Dict[str, int], sizes: Dict[str, int], n: int
           ) -> slice:
    """The slice of ``n`` rows (or columns) a slot's coordinates select
    over ``axes`` (the first axis outermost), all of them for none."""
    if not axes:
        return slice(0, n)
    k, idx = 1, 0
    for a in axes:
        idx, k = idx * sizes[a] + coords[a], k * sizes[a]
    if n % k:
        raise ValueError(f"{n} does not split over {k} slots of {axes}")
    per = n // k
    return slice(idx * per, (idx + 1) * per)


def make_global_batch(ds: SyntheticLM, step: int, mesh, spec
                      ) -> Dict[str, np.ndarray]:
    """The global batch laid out on ``mesh`` by ``spec`` (a
    :class:`~repro_torch.parallel.sharding.P` over ``(batch, seq)``):
    ``{"tokens", "labels": [n_ranks, rows, cols]}``, row ``r`` the block
    of virtual rank ``r``.

    Mesh slot ``i`` is placed on rank ``mesh.order[i]``; its coordinates
    along the axes ``spec`` names select its block, and along the other
    axes (``model``) the block is replicated.
    """
    from repro_torch.parallel.sharding import mesh_axis_sizes, spec_axes

    sizes = mesh_axis_sizes(mesh)
    parts = list(spec) + [None] * (2 - len(spec))
    shape = tuple(sizes[a] for a in mesh.axis_names)
    out: Dict[str, list] = {"tokens": [None] * len(mesh.order),
                            "labels": [None] * len(mesh.order)}
    made: Dict[tuple, Dict[str, np.ndarray]] = {}
    for slot, rank in enumerate(mesh.order):
        coords = dict(zip(mesh.axis_names, np.unravel_index(slot, shape)))
        rows = _block(spec_axes(parts[0]), coords, sizes, ds.batch)
        cols = _block(spec_axes(parts[1]), coords, sizes, ds.seq)
        key = (rows.start, rows.stop)
        if key not in made:     # a block replicated over other axes: once
            made[key] = ds.batch_rows(step, np.arange(ds.batch)[rows])
        data = made[key]
        for name in out:
            out[name][rank] = data[name][:, cols]
    return {k: np.stack(v) for k, v in out.items()}


def batches(ds: SyntheticLM, mesh=None, spec=None, start_step: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches from ``start_step`` on: the host batch without a mesh,
    else :func:`make_global_batch` (``spec`` replicated by default)."""
    from repro_torch.parallel.sharding import P

    step = start_step
    while True:
        if mesh is None:
            yield host_batch(ds, step)
        else:
            yield make_global_batch(ds, step, mesh, spec or P())
        step += 1
