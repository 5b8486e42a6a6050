"""Dynamic rank adaptation (paper §VI), a copy of ``repro.core.dynamic``.

The paper sketches two runtime mechanisms we implement fully:

* **bottleneck replacement** — "we can determine the critical path and
  find bottleneck transfer between node n_i and n_j ... find a n_k to
  replace n_i such that the replacement results in a minimized cost
  objective".  :func:`bottleneck_swap` does exactly this: locate the
  critical edge via :meth:`CostModel.critical_edges`, try swapping either
  endpoint with every other node (batched evaluation), keep the best.

* **adaptation to dynamic traffic** — :class:`AdaptiveReranker` consumes
  refreshed cost matrices (from live TCP_INFO-style link monitoring, from
  re-probes, or from the trainer's straggler detector) and re-ranks when
  the current order has degraded beyond a threshold.  The paper notes the
  framework must tolerate rank changes cheaply because "a full mesh of
  connections can be established beforehand" — in this port's terms: a
  new order is a new rank order for the certified schedule, and on the
  single-card virtual mesh nothing has to move.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from .cost_models import CostModel

__all__ = ["bottleneck_swap", "AdaptiveReranker", "StragglerDetector"]


def bottleneck_swap(
    cost_model: CostModel,
    perm: np.ndarray,
    max_rounds: int = 8,
) -> Tuple[np.ndarray, float, List[Tuple[int, int]]]:
    """Iteratively repair the critical edge by endpoint replacement.

    Returns (new_perm, new_cost, swaps applied).  Each round is O(N)
    candidate evaluations (batched), so this is cheap enough to run
    online between training steps.
    """
    perm = np.asarray(perm).copy()
    cur = cost_model.cost(perm)
    swaps: List[Tuple[int, int]] = []
    n = len(perm)
    pos_of = np.empty(n, dtype=np.int64)
    rows = np.arange(n)

    for _ in range(max_rounds):
        crit = cost_model.critical_edges(perm)
        if not crit:
            break
        a, b, _ = max(crit, key=lambda t: t[2])
        pos_of[perm] = rows
        # candidates for both endpoints in one [2n, n] batch: row
        # (e * n + k) swaps endpoint e's rank with node k's rank
        cands = np.tile(perm, (2 * n, 1))
        other_pos = pos_of[rows]
        for e, endpoint in enumerate((a, b)):
            pe = pos_of[endpoint]
            blk = cands[e * n : (e + 1) * n]
            blk[rows, pe] = perm[other_pos]
            blk[rows, other_pos] = endpoint
        costs = cost_model.cost_batch(cands)
        k = int(np.argmin(costs))
        if costs[k] >= cur - 1e-15:
            break
        e, kk = divmod(k, n)
        perm, cur = cands[k], float(costs[k])
        swaps.append(((a, b)[e], kk))
    return perm, cur, swaps


@dataclasses.dataclass
class AdaptiveReranker:
    """Re-rank online when the network (or a straggler) degrades.

    ``model_factory(cost_matrix) -> CostModel`` rebuilds the objective for
    a refreshed cost matrix; re-ranking triggers when the current order's
    cost exceeds ``threshold`` x its cost at the last (re)solve.
    """

    model_factory: Callable[[np.ndarray], CostModel]
    perm: np.ndarray
    threshold: float = 1.15
    #: cost of `perm` under the matrix that last produced it
    reference_cost: Optional[float] = None
    history: List[Tuple[float, float, bool]] = dataclasses.field(default_factory=list)

    def update(self, cost_matrix: np.ndarray) -> Tuple[np.ndarray, bool]:
        c = np.asarray(cost_matrix, dtype=np.float64)
        n = len(self.perm)
        if c.ndim != 2 or c.shape[0] != c.shape[1]:
            raise ValueError(
                f"AdaptiveReranker.update cost_matrix must be a square "
                f"[n, n] matrix; got shape {c.shape}")
        if c.shape[0] != n:
            raise ValueError(
                f"AdaptiveReranker.update cost_matrix covers {c.shape[0]} "
                f"nodes but the tracked permutation covers {n}")
        if np.isnan(c).any():
            raise ValueError(
                f"AdaptiveReranker.update cost_matrix contains "
                f"{int(np.isnan(c).sum())} NaN entries; a corrupted probe "
                f"sample must be dropped upstream, not fed into the "
                f"re-rank objective")
        if (c < 0).any():
            i, j = np.argwhere(c < 0)[0]
            raise ValueError(
                f"AdaptiveReranker.update cost_matrix contains negative "
                f"entries (first at [{i}, {j}] = {c[i, j]}); costs are "
                f"times and must be >= 0")
        model = self.model_factory(c)
        cur = model.cost(self.perm)
        if self.reference_cost is None:
            self.reference_cost = cur
        changed = False
        if cur > self.threshold * self.reference_cost:
            new_perm, new_cost, swaps = bottleneck_swap(model, self.perm)
            if swaps and new_cost < cur:
                self.perm = new_perm
                self.reference_cost = new_cost
                changed = True
                cur = new_cost
        self.history.append((float(cur), float(self.reference_cost), changed))
        return self.perm, changed


class StragglerDetector:
    """Per-node EWMA of step/transfer times -> cost-matrix inflation.

    Feeds :class:`AdaptiveReranker`: a node whose EWMA exceeds
    ``ratio_threshold`` x the median is treated as if all its links
    slowed down proportionally (the latency analogue of a slow worker).
    """

    def __init__(self, n: int, alpha: float = 0.2, ratio_threshold: float = 1.5):
        self.n = n
        self.alpha = alpha
        self.ratio_threshold = ratio_threshold
        self.ewma = np.zeros(n)
        self._initialized = np.zeros(n, dtype=bool)

    def observe(self, node: int, seconds: float) -> None:
        if not self._initialized[node]:
            self.ewma[node] = seconds
            self._initialized[node] = True
        else:
            self.ewma[node] = (1 - self.alpha) * self.ewma[node] + self.alpha * seconds

    def stragglers(self) -> np.ndarray:
        ready = self._initialized
        if ready.sum() < max(2, self.n // 2):
            return np.zeros(0, dtype=np.int64)
        med = np.median(self.ewma[ready])
        mask = ready & (self.ewma > self.ratio_threshold * med)
        return np.nonzero(mask)[0]

    def inflate(self, cost_matrix: np.ndarray) -> np.ndarray:
        """Return a copy of the cost matrix with straggler rows/cols scaled."""
        c = cost_matrix.copy()
        ready = self._initialized
        if not ready.any():
            return c
        med = float(np.median(self.ewma[ready])) or 1.0
        for node in self.stragglers():
            f = float(self.ewma[node] / med)
            c[node, :] *= f
            c[:, node] *= f
        np.fill_diagonal(c, 0.0)
        return c
