"""Tensor parallelism over the model axis of a virtual mesh.

The port's own module: it has no counterpart in the reference, where
GSPMD partitions the step from the specs of
:mod:`repro_torch.parallel.sharding` and inserts the collectives.  Here
the specs decide the storage and the collectives are written out, each
one a certified schedule run by
:func:`repro_torch.kernels.schedule_runner.run_schedule` (on the card
every reduce of it is a ``fused_add`` launch), as on the data axis.

Layout.  A parameter whose spec names ``model`` on dimension ``k`` is
held as ``[m, *local]`` (:func:`shard_params`): row ``j`` is model rank
``j``'s contiguous slice of dimension ``k``.  A replicated parameter is
held once.  Activations follow the same convention: a sharded activation
carries the model axis as its leading dimension, so one launch (a
batched matmul) computes all ``m`` ranks' products; a replicated
activation is held once and stands for every rank's identical copy, and
what a spec leaves replicated is computed once, with no collective — what
each rank computes whole.

The model axis's ranks.  Model group ``i`` is the mesh slots ``(i, 0..m-1)``,
placed on ranks ``order[i*m + j]``; its schedules are rings over local
ranks ``0..m-1`` in slot order, the rings
:func:`repro_torch.core.reorder.mesh_axis_cost` priced when the plan
placed the slots.  Data-axis group ``j`` is the slots ``(0..d-1, j)``.

The collectives, as autograd Functions (Megatron-LM's pair and the
vocab-parallel loss's gather):

* :meth:`TensorParallel.reduce` — the row-parallel output: the ``m``
  ranks' partial sums ``[m, ...]`` all-reduced into the replicated
  value.  Its backward hands every rank the replicated gradient
  unchanged: the value is held once, so its gradient is every rank's.
* :meth:`TensorParallel.scatter` — the conjugate identity at a
  column-parallel input: forward, every rank reads the replicated value;
  backward, the ranks' gradients ``[m, ...]`` are all-reduced, the sum
  the replicated value's gradient is.
* :meth:`TensorParallel.gather` — an all-gather of one value a rank into
  the replicated ``[m, ...]``; backward, each rank keeps its own row of
  the replicated gradient.
* :meth:`TensorParallel.split` — each rank takes its slice of a
  replicated value (the MoE layer's rows, split along S); backward, the
  ranks' slices of the gradient are all-gathered into the replicated
  gradient.
* :meth:`TensorParallel.gather_each` — a sharded weight all-gathered to
  its full shape on every rank (the reference's weight gather of the
  experts); each rank then uses its copy on its own tokens, so backward
  the ranks' gradients ``[m, *full]`` are reduce-scattered, each rank
  keeping the sum of its own shard (a certified ring reduce-scatter,
  ``fused_add`` its reduce).

Nothing sums over the rank dimension outside the runner.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.collective.executors import LoweredSchedule
from repro_torch.kernels import accounting
from repro_torch.kernels.schedule_runner import run_schedule
from repro_torch.tree import tree_leaves, tree_unflatten

from .sharding import P, mesh_axis_sizes

__all__ = ["TensorParallel", "certified_all_gather",
           "certified_reduce_scatter", "model_dim",
           "shard_params", "unshard_params", "unbind_blocks", "tp_linear",
           "model_groups", "data_groups", "TP_FAMILIES", "require_tp_family"]

#: model families whose forward runs tensor-parallel (MoE with GQA
#: attention: its experts gathered over the model axis)
TP_FAMILIES = ("dense", "vlm", "moe")


def require_tp_family(cfg) -> None:
    """Raise for a model a model axis cannot shard yet (ROADMAP.md §1)."""
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family!r}, MLA) on a model axis: the "
            f"reference shards wq_a/wq_b/wkv_a/wkv_b/wk_rope, whose "
            f"tensor-parallel attention waits for ROADMAP.md §1 item 23")
    items = {"ssm": "item 20", "hybrid": "item 21"}
    if cfg.family in items:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family!r}) on a model axis: tensor parallelism "
            f"for this family waits for ROADMAP.md §1 {items[cfg.family]}")
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family!r}) has no tensor-parallel forward; "
            f"the dense family and the VLM do")


def model_dim(spec: P) -> Optional[int]:
    """The dimension a spec shards over ``model``, or None."""
    for i, part in enumerate(spec):
        if part == "model" or (isinstance(part, tuple) and "model" in part):
            return i
    return None


def shard_params(params: Any, pspecs: Any, m: int) -> Any:
    """Model-axis storage: ``[m, *local]`` where the spec names ``model``
    (``local`` the logical shape with that dim divided by ``m``), the
    tensor itself where it does not."""
    out = []
    for t, spec in zip(tree_leaves(params), tree_leaves(pspecs)):
        k = model_dim(spec)
        out.append(t if k is None or m == 1 else
                   torch.stack(torch.chunk(t, m, dim=k)).contiguous())
    return tree_unflatten(params, out)


def unshard_params(storage: Any, pspecs: Any) -> Any:
    """The logical tree of :func:`shard_params`'s storage."""
    out = []
    for t, spec in zip(tree_leaves(storage), tree_leaves(pspecs)):
        k = model_dim(spec)
        sharded = k is not None and t.dim() == len(spec) + 1
        out.append(torch.cat(list(torch.unbind(t)), dim=k) if sharded else t)
    return tree_unflatten(storage, out)


def unbind_blocks(tree: Any, specs: Any, n: int) -> List[Tuple[Any, Any]]:
    """The ``n`` layers of stacked block storage with their per-layer
    specs: a sharded leaf ``[m, n, ...]`` unbinds on dim 1, a replicated
    ``[n, ...]`` on dim 0 (one unbind a leaf, as
    :func:`repro_torch.models.layers.unbind_layers`)."""
    def split(t, s):
        if isinstance(t, dict):
            return {k: split(t[k], s[k]) for k in t}
        return torch.unbind(t, dim=1 if model_dim(s) is not None else 0)

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]

    def layer_spec(s):
        return {k: layer_spec(v) for k, v in s.items()} if isinstance(s, dict) \
            else P(*s[1:])

    parts = split(tree, specs)
    spec = layer_spec(specs)
    return [(pick(parts, i), spec) for i in range(n)]


def tp_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [m, ..., K] @ w [m, K, N]`` rank by rank, in one batched matmul."""
    m = w.shape[0]
    y = torch.bmm(x.reshape(m, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def model_groups(order, m: int) -> List[List[int]]:
    """The model-axis groups' ranks, slot order: ``order[i*m + j]``."""
    return [list(order[i:i + m]) for i in range(0, len(order), m)]


def data_groups(order, m: int) -> List[List[int]]:
    """The data-axis groups' ranks: slots ``(0..d-1, j)``."""
    return [list(order[j::m]) for j in range(m)]


@functools.lru_cache(maxsize=32)
def certified_all_gather(n: int) -> LoweredSchedule:
    """A certified ring ``all_gather`` over ``n`` local ranks in slot
    order, compiled, lowered and proved by
    :func:`repro_torch.analysis.require_certified` before it is returned."""
    from repro_torch.analysis import require_certified
    from repro_torch.collective import (
        CollectiveOp, ScheduleLowering, compile_op)

    op = CollectiveOp(kind="all_gather", size_bytes=float(n),
                      group=tuple(range(n)))
    prog = compile_op(op, "ring_all_gather")
    sched = ScheduleLowering().lower_schedule(prog)
    require_certified(prog, sched)
    return sched


@functools.lru_cache(maxsize=32)
def certified_reduce_scatter(n: int) -> LoweredSchedule:
    """A certified ring ``reduce_scatter`` over ``n`` local ranks in slot
    order (rank ``k`` ends with the sum of chunk ``k``), proved before it
    is returned."""
    from repro_torch.analysis import require_certified
    from repro_torch.collective import (
        CollectiveOp, ScheduleLowering, compile_op)

    op = CollectiveOp(kind="reduce_scatter", size_bytes=float(n),
                      group=tuple(range(n)))
    prog = compile_op(op, "ring_all_gather")
    sched = ScheduleLowering().lower_schedule(prog)
    require_certified(prog, sched)
    return sched


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.lru_cache(maxsize=32)
def _certified_allreduce(n: int) -> LoweredSchedule:
    from repro_torch.train.overlap_grads import certified_allreduce

    return certified_allreduce(n, float(n), "ring")


def all_reduce_rows(x: torch.Tensor, sched: LoweredSchedule,
                    use_kernel_add: bool = True) -> torch.Tensor:
    """``x [n, ...]`` all-reduced by ``sched``: the sum every rank holds
    (rank 0's row), shaped ``x.shape[1:]``."""
    n = sched.n
    flat = x.reshape(n, -1)
    width = flat.shape[1]
    pad = (-width) % (sched.n_chunks * max(1, sched.chunk_factor))
    if pad:
        flat = torch.cat([flat, flat.new_zeros((n, pad))], dim=1)
    out = run_schedule(flat, sched, use_kernel_add)
    return out[0].reshape(-1)[:width].reshape(x.shape[1:])


def all_gather_rows(x: torch.Tensor, sched: LoweredSchedule) -> torch.Tensor:
    """``x [n, ...]`` all-gathered by ``sched``: the ``[n, ...]`` every
    rank holds (rank 0's copy)."""
    n = sched.n
    out = run_schedule(x.reshape(n, -1), sched, False)
    return out[0].reshape(x.shape)


def reduce_scatter_rows(x: torch.Tensor, sched: LoweredSchedule,
                        use_kernel_add: bool = True) -> torch.Tensor:
    """``x [n, n, ...]`` (rank ``j``'s contribution to every rank's
    chunk) reduce-scattered by ``sched``: ``[n, ...]``, row ``k`` the sum
    over ``j`` of ``x[j, k]``."""
    n = sched.n
    out = run_schedule(x.reshape(n, -1), sched, use_kernel_add)
    pick = torch.arange(n, device=x.device)
    return out[pick, pick].reshape(x.shape[1:])


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.shape = x.shape
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(0).expand(ctx.shape), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.unsqueeze(0).expand(tp.m, *x.shape)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return x.unflatten(dim, (tp.m, x.shape[dim] // tp.m)).movedim(dim, 0)

    @staticmethod
    def backward(ctx, g):
        whole = ctx.tp.all_gather(g.contiguous())
        return whole.movedim(0, ctx.dim).flatten(ctx.dim, ctx.dim + 1), \
            None, None


class _GatherEach(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        full = torch.cat(list(tp.all_gather(x).unbind(0)), dim=dim)
        return full.unsqueeze(0).expand(tp.m, *full.shape)

    @staticmethod
    def backward(ctx, g):
        m, dim = ctx.tp.m, ctx.dim
        # [ranks, *full] -> [ranks, shards, *local]: rank j's gradient of
        # every shard, shard k at chunk k
        parts = g.unflatten(dim + 1, (m, g.shape[dim + 1] // m)).movedim(
            dim + 1, 1)
        return ctx.tp.reduce_scatter(parts.contiguous()), None, None


class TensorParallel:
    """The model axis of a mesh: its size, the parameters' specs and the
    certified schedules its collectives run.

    ``counts`` tallies the schedule runs by kind (``allreduce``,
    ``allgather``, and ``reducescatter`` once one has run), forward,
    backward and recompute alike.  Each run is also reported to an open
    :class:`~repro_torch.kernels.accounting.KernelWork` as one rank's
    result; ``groups`` is the number of data-parallel groups whose runs
    the caller makes one after another (1 outside a step's per-group
    gradients), of which a rank takes part in one.
    """

    def __init__(self, mesh, pspecs: Any, use_kernel_add: bool = True):
        self.m = mesh_axis_sizes(mesh).get("model", 1)
        if self.m < 2:
            raise ValueError(f"tensor parallelism needs a model axis of 2 or "
                             f"more slots, mesh {dict(mesh_axis_sizes(mesh))}")
        self.pspecs = pspecs
        self.use_kernel_add = use_kernel_add
        self.allreduce_schedule = _certified_allreduce(self.m)
        self.allgather_schedule = certified_all_gather(self.m)
        self.reducescatter_schedule = certified_reduce_scatter(self.m)
        self.counts: Dict[str, int] = {"allreduce": 0, "allgather": 0}
        self.groups = 1

    # -- the schedule runs --------------------------------------------------
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``[m, ...]`` rank partials -> their sum ``[...]``."""
        self.counts["allreduce"] += 1
        accounting.collective("all-reduce", lambda: _nbytes(x[0]),
                              self.groups)
        return all_reduce_rows(x, self.allreduce_schedule, self.use_kernel_add)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[m, ...]`` one row a rank -> the gathered ``[m, ...]``."""
        self.counts["allgather"] += 1
        accounting.collective("all-gather", lambda: _nbytes(x), self.groups)
        return all_gather_rows(x, self.allgather_schedule)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``[m, m, ...]`` every rank's share of every chunk -> ``[m, ...]``,
        rank ``k`` holding the sum of chunk ``k``."""
        self.counts["reducescatter"] = self.counts.get("reducescatter", 0) + 1
        accounting.collective("reduce-scatter", lambda: _nbytes(x[0, 0]),
                              self.groups)
        return reduce_scatter_rows(x, self.reducescatter_schedule,
                                   self.use_kernel_add)

    # -- differentiable -----------------------------------------------------
    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """Row-parallel output: the ranks' partials summed, replicated."""
        return _Reduce.apply(partial, self)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Column-parallel input: the replicated ``x`` on every rank."""
        return _Scatter.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's row of ``x [m, ...]``, replicated."""
        return _Gather.apply(x, self)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Rank ``j``'s slice ``j`` of the replicated ``x`` along ``dim``:
        ``[m, ...]`` with ``dim`` cut by ``m``."""
        return _Split.apply(x, self, dim)

    def gather_each(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Storage ``[m, *local]`` sharded on local dimension ``dim``,
        all-gathered: ``[m, *full]``, every rank's copy of the whole
        (held once; the gradients of the copies are reduce-scattered)."""
        return _GatherEach.apply(x, self, dim)

    # -- the clip's global norm ---------------------------------------------
    def global_norm(self, grads: Any) -> torch.Tensor:
        """sqrt of the sum of squares of the logical gradient tree.

        Each rank sums the squares of its shards of the sharded leaves; a
        replicated leaf, which every rank holds whole, is counted once (on
        rank 0); the ``m`` partials are all-reduced over the model axis.
        """
        partial, shared = None, None
        for g, spec in zip(tree_leaves(grads), tree_leaves(self.pspecs)):
            sq = torch.square(g.float())
            if model_dim(spec) is not None:
                s = sq.reshape(self.m, -1).sum(1)
                partial = s if partial is None else partial + s
            else:
                s = torch.sum(sq)
                shared = s if shared is None else shared + s
        if partial is None:
            partial = torch.zeros(self.m, dtype=torch.float32,
                                  device=tree_leaves(grads)[0].device)
        if shared is not None:
            partial = torch.cat([partial[:1] + shared, partial[1:]])
        return torch.sqrt(self.all_reduce(partial[:, None])[0])
