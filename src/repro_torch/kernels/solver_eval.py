"""Batched ring-cost evaluators for the solver (counterpart of
``repro.kernels.solver_eval``, the ``backend="jax"`` path).

The numpy SA engine in :mod:`repro_torch.core.solver` scores a ``[P, N]``
batch of ring permutations with one gather; at hundreds of chains and
N >= 1024 the gather and the sum run on the card instead, with the cost
matrix resident there.  ``solve_sa(..., backend="jax")`` (the reference's
spelling) routes its full evaluations here; the O(K) delta path stays in
numpy.

Precision: the evaluation runs in float32, as the reference's (JAX
without x64), so a cost carries about 1e-7 relative rounding against the
float64 numpy path.  That can flip Metropolis decisions on near-tied
orderings mid-run; it never changes the *reported* solver cost, which
``solve_sa`` recomputes in float64.

The device defaults to ``cuda`` (:func:`repro_torch.resolve_device`):
without a card the evaluator raises rather than run in numpy; the CPU
runs only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

__all__ = ["make_ring_evaluator", "ring_cost_batch"]


def _ring_cost(c: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    # cost = sum_i c[perm[i], perm[i-1]]: one gather a batch
    return c[perms, torch.roll(perms, 1, dims=1)].sum(dim=1)


def _perms(perms: np.ndarray, device: torch.device) -> torch.Tensor:
    perms = np.asarray(perms)
    if perms.ndim == 1:
        perms = perms[None, :]
    return torch.as_tensor(perms.astype(np.int64, copy=False), device=device)


def ring_cost_batch(cmat: np.ndarray, perms: np.ndarray,
                    device: Any = "cuda") -> np.ndarray:
    """Ring tour costs ``[P]`` (float64 from float32 sums) for a ``[P, N]``
    permutation batch (or one ``[N]`` permutation)."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(cmat, dtype=np.float32), device=dev)
    return _ring_cost(c, _perms(perms, dev)).cpu().numpy().astype(np.float64)


def make_ring_evaluator(cmat: np.ndarray, device: Any = "cuda"
                        ) -> Callable[[np.ndarray], np.ndarray]:
    """Bind ``cmat`` once; returns ``perms -> [P] costs``.

    The matrix moves to the device a single time, so a call ships only
    the permutation batch (int64) and brings back ``P`` costs.
    """
    from repro_torch import resolve_device

    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(cmat, dtype=np.float32), device=dev)

    def evaluate(perms: np.ndarray) -> np.ndarray:
        return _ring_cost(c, _perms(perms, dev)).cpu().numpy().astype(np.float64)

    return evaluate
