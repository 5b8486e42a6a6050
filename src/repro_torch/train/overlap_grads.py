"""Bucketed data-parallel gradient all-reduce through certified schedules.

Port of ``repro.train.overlap_grads``, on the single-card virtual mesh:
the n data-parallel ranks are the leading dimension of one tensor.

* the grad tree is partitioned into size-targeted **buckets**
  (:func:`partition_tree`), in the reference's leaf order;
* each bucket's payload runs the **certified** all-reduce schedule —
  :func:`certified_allreduce` compiles, permutes, chunks, lowers and
  proves it with :func:`repro_torch.analysis.require_certified` before
  anything runs it;
* buckets are **pipelined**: bucket ``b``'s rounds run with bucket
  ``b - 1``'s finishing math (un-flatten, mean) as resident compute, at
  bucket granularity (``mode="bucketed"``) or leaf by leaf across the
  rounds (``mode="fused"``); ``sequential`` finishes every bucket at the
  end.

Every mode computes the same reduction element for element.  Two
transports carry a bucket:

* ``transport="runner"`` (the default of :class:`OverlapGradReducer`):
  :func:`~repro_torch.kernels.overlap.run_overlapped` runs the schedule
  round by round, and the reduce of every round goes through the
  ``fused_add`` kernel on the card (``use_kernel_add=True``, the
  default); ``use_kernel_add=False`` reduces with plain ``+``, which
  gives the same bits for f32 and bf16;
* ``transport="peer_ring"`` (the default of :func:`reducer_from_plan`):
  one launch of the peer-memory ring kernel
  (:func:`~repro_torch.kernels.ring_collective.remote_ring_reduce_scatter`)
  a bucket, in the certified ring schedule's ``order``.

:func:`make_overlap_train_step` is the data-parallel step: each virtual
rank computes the loss and its gradient on its contiguous batch shard
(what the reference's ``shard_map`` does), the grads go into row r of
stacked ``[n, ...]`` buffers, the reducer takes their mean, and AdamW
applies it.  :func:`reducer_from_plan` builds the reducer from the
planner's :class:`~repro_torch.plan.Plan`: the planned bucket size, the
planned algorithm and rank order, certified before use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis import require_certified
from repro_torch.collective import CollectiveOp, Program, ScheduleLowering, compile_op
from repro_torch.collective.executors import LoweredSchedule
from repro_torch.collective.passes import apply_permutation, chunk as chunk_pass
from repro_torch.kernels import accounting
from repro_torch.kernels.overlap import run_overlapped
from repro_torch.kernels.ring_collective import remote_ring_reduce_scatter
from repro_torch.optim import apply_opt
from repro_torch.tree import tree_leaves, tree_unflatten

from .train_step import TrainState, batch_on, value_and_grad

__all__ = [
    "GradBucket",
    "partition_tree",
    "certified_allreduce",
    "certified_allreduce_pair",
    "OverlapGradReducer",
    "reducer_from_plan",
    "make_overlap_train_step",
    "stacked_grads",
    "OVERLAP_MODES",
]

OVERLAP_MODES = ("sequential", "bucketed", "fused")
TRANSPORTS = ("runner", "peer_ring")


@dataclasses.dataclass(frozen=True)
class GradBucket:
    """One size-targeted slice of the (flattened) grad tree."""

    index: int
    leaf_ids: Tuple[int, ...]        # indices into the tree's leaf order
    sizes: Tuple[int, ...]           # per-leaf element counts
    n_elems: int
    n_bytes: int


def partition_tree(tree, bucket_bytes: float,
                   leading_axis: bool = False) -> List[GradBucket]:
    """Greedy size-targeted partition of a tree, in leaf order.

    ``bucket_bytes <= 0`` yields a single bucket.  With
    ``leading_axis=True`` leaves carry a stacked per-rank axis 0 that
    does not count toward the payload.  Leaves need only ``.shape`` and
    a torch ``.dtype``.
    """
    buckets: List[GradBucket] = []
    cur_ids: List[int] = []
    cur_sizes: List[int] = []
    cur_bytes = 0
    for i, leaf in enumerate(tree_leaves(tree)):
        shape = tuple(leaf.shape)[1:] if leading_axis else tuple(leaf.shape)
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = size * leaf.dtype.itemsize
        if cur_ids and bucket_bytes > 0 and cur_bytes + nbytes > bucket_bytes:
            buckets.append(GradBucket(
                index=len(buckets), leaf_ids=tuple(cur_ids),
                sizes=tuple(cur_sizes), n_elems=sum(cur_sizes),
                n_bytes=cur_bytes))
            cur_ids, cur_sizes, cur_bytes = [], [], 0
        cur_ids.append(i)
        cur_sizes.append(size)
        cur_bytes += nbytes
    if cur_ids:
        buckets.append(GradBucket(
            index=len(buckets), leaf_ids=tuple(cur_ids),
            sizes=tuple(cur_sizes), n_elems=sum(cur_sizes),
            n_bytes=cur_bytes))
    return buckets


def certified_allreduce_pair(n: int, size_bytes: float, algo: str = "ring",
                             perm: Optional[Sequence[int]] = None,
                             chunk_factor: int = 1, **algo_kwargs
                             ) -> Tuple[Program, LoweredSchedule]:
    """Compile, lower and certify an all-reduce for ``n`` ranks; returns
    the ``(program, schedule)`` pair (what a runner that certifies its
    own input, :func:`repro_torch.kernels.group_runner.run_schedule_group`,
    takes).

    ``perm`` is the rank order (local indices); ``chunk_factor`` splits
    each chunk into serial pieces.  The schedule is proved against its
    program by :func:`repro_torch.analysis.require_certified` before it
    is returned.
    """
    op = CollectiveOp(kind="allreduce", size_bytes=float(size_bytes),
                      group=tuple(range(n)))
    prog = compile_op(op, algo, **algo_kwargs)
    if perm is not None:
        prog = apply_permutation(prog, [int(p) for p in perm])
    if chunk_factor > 1:
        prog = chunk_pass(prog, chunk_factor)
    sched = ScheduleLowering().lower_schedule(prog)
    require_certified(prog, sched)
    return prog, sched


def certified_allreduce(n: int, size_bytes: float, algo: str = "ring",
                        perm: Optional[Sequence[int]] = None,
                        chunk_factor: int = 1,
                        **algo_kwargs) -> LoweredSchedule:
    """The certified schedule of :func:`certified_allreduce_pair`."""
    return certified_allreduce_pair(n, size_bytes, algo, perm, chunk_factor,
                                    **algo_kwargs)[1]


class OverlapGradReducer:
    """Bucketed, certified data-parallel gradient mean on the virtual mesh.

    Callable on a *stacked* grad tree (leaves ``[n, ...]``, row r = rank
    r's grads): returns the mean tree plus any resident-compute results.
    The same certified schedule runs every bucket — the lowering does not
    depend on the payload, so the runner's cached index tables serve
    every bucket of every step.

    ``transport="runner"`` runs each bucket through
    :func:`~repro_torch.kernels.overlap.run_overlapped`, with the
    previous bucket's finisher and the caller's compute spread over its
    rounds.  ``transport="peer_ring"`` runs each bucket's payload through
    one launch of the peer-memory ring kernel at the schedule's ring
    ``order`` (a ring schedule only; any other algorithm is refused).
    The chunks come back in rank order, so on the virtual mesh the
    all-gather is the reduce-scatter's rows laid end to end.  Its
    ``chunk_factor`` is not used: the launch moves whole chunks.  The
    modes keep bucket granularity: bucket b-1's finisher (one thunk in
    ``bucketed``, one a leaf in ``fused``) and the caller's compute run
    after bucket b's launch is queued, so the host's work overlaps the
    card's; ``sequential`` finishes every bucket at the end.
    """

    def __init__(self, schedule: LoweredSchedule, bucket_bytes: float = 0.0,
                 mode: str = "bucketed", use_kernel_add: bool = True,
                 transport: str = "runner"):
        if mode not in OVERLAP_MODES:
            raise ValueError(f"mode must be one of {OVERLAP_MODES}, "
                             f"got {mode!r}")
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, "
                             f"got {transport!r}")
        if schedule.postcondition != "allreduce":
            raise ValueError("OverlapGradReducer needs an all-reduce "
                             f"schedule, got {schedule.postcondition!r}")
        if transport == "peer_ring" and schedule.algorithm != "ring":
            raise ValueError(
                "the peer_ring transport runs a ring schedule only, got "
                f"{schedule.algorithm!r}; use transport='runner'")
        self.schedule = schedule
        self.bucket_bytes = float(bucket_bytes)
        self.mode = mode
        self.use_kernel_add = use_kernel_add
        self.transport = transport
        self.n = schedule.n

    # -- bucketing ---------------------------------------------------------
    def buckets_for(self, stacked_tree) -> List[GradBucket]:
        return partition_tree(stacked_tree, self.bucket_bytes,
                              leading_axis=True)

    def record_buckets(self, stacked_tree) -> List[GradBucket]:
        """Report the per-bucket all-reduce payloads to ``repro_torch.obs``."""
        buckets = self.buckets_for(stacked_tree)
        rec = obs.recorder()
        for b in buckets:
            rec.record("all-reduce", float(b.n_bytes))
        obs.metrics().gauge("train.overlap.buckets").set(len(buckets))
        return buckets

    # -- the reduction -----------------------------------------------------
    def _payload(self, leaves: List[torch.Tensor], bkt: GradBucket,
                 shares: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Bucket ``bkt`` as ``[n, D]``, zero-padded to the schedule's
        quantum; reported to an open
        :class:`~repro_torch.kernels.accounting.KernelWork` as one
        all-reduce of one rank's gradients (``shares``: see
        :meth:`__call__`)."""
        n = self.n
        quantum = self.schedule.n_chunks * max(1, self.schedule.chunk_factor)
        flat = [leaves[i].reshape(n, -1) for i in bkt.leaf_ids]
        pad = (-bkt.n_elems) % quantum
        accounting.collective("all-reduce", lambda: sum(
            sz // (shares[i] if shares else 1)
            for i, sz in zip(bkt.leaf_ids, bkt.sizes))
            * leaves[bkt.leaf_ids[0]].element_size())
        if pad:
            flat.append(flat[0].new_zeros((n, pad)))
        return flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)

    def __call__(self, stacked_tree,
                 compute: Sequence[Callable[[], Any]] = (),
                 shares: Optional[Sequence[int]] = None
                 ) -> Tuple[Any, List[Any]]:
        """The mean of ``stacked_tree``'s ``[n, ...]`` leaves over the
        ranks, and ``compute``'s results.  ``shares`` (per leaf, default
        1): the ranks of a real mesh whose pieces one row of the leaf
        holds (the model axis's ``m`` for a leaf in model-axis storage),
        so that a rank's all-reduce carries ``1/share`` of the row."""
        leaves = tree_leaves(stacked_tree)
        buckets = self.buckets_for(stacked_tree)
        n = self.n
        # rank 0's row of the result (every rank holds the same sum)
        pos0 = self.schedule.order[0]
        n_chunks = self.schedule.n_chunks

        outs: List[Any] = [None] * len(buckets)
        finished: Dict[int, Any] = {}
        results: List[Any] = [None] * len(compute)
        shapes = [tuple(leaf.shape)[1:] for leaf in leaves]

        def finisher_shards(b: int):
            """Thunks turning bucket ``b``'s raw output into mean leaves.

            ``bucketed``: one shard per bucket; ``fused``: one per leaf,
            so the plan spreads them across the next bucket's rounds.
            """
            bkt = buckets[b]

            def vec():
                return outs[b][:bkt.n_elems] / n

            if self.mode == "fused":
                shards = []
                off = 0
                for i, sz in zip(bkt.leaf_ids, bkt.sizes):
                    def one(i=i, off=off, sz=sz):
                        return vec()[off:off + sz].reshape(shapes[i])
                    shards.append((i, one))
                    off += sz
                return shards

            def whole(bkt=bkt):
                v, off, out = vec(), 0, []
                for i, sz in zip(bkt.leaf_ids, bkt.sizes):
                    out.append(v[off:off + sz].reshape(shapes[i]))
                    off += sz
                return out
            return [(("bucket", b), whole)]

        def land(tag, value):
            if isinstance(tag, tuple) and tag[0] == "bucket":
                bkt = buckets[tag[1]]
                for i, leaf in zip(bkt.leaf_ids, value):
                    finished[i] = leaf
            elif isinstance(tag, tuple) and tag[0] == "user":
                results[tag[1]] = value
            else:
                finished[tag] = value

        user_split = np.array_split(np.arange(len(compute)),
                                    max(1, len(buckets)))
        pipelined = self.mode != "sequential"
        for b, bkt in enumerate(buckets):
            shards = []
            if pipelined and b > 0:
                shards.extend(finisher_shards(b - 1))
            shards.extend(
                (("user", int(u)), compute[int(u)]) for u in user_split[b])
            if self.transport == "peer_ring":
                # queued on the stream; the thunks below run behind it
                outs[b] = remote_ring_reduce_scatter(
                    self._payload(leaves, bkt, shares),
                    perm=self.schedule.order).reshape(-1)
                res = [fn() for _, fn in shards]
            else:
                state, res = run_overlapped(
                    self._payload(leaves, bkt, shares), self.schedule,
                    compute=[fn for _, fn in shards],
                    use_kernel_add=self.use_kernel_add, return_state=True)
                # out[0] of run_schedule, kept without the other ranks' rows
                outs[b] = state[pos0, :n_chunks].reshape(-1).clone()
                del state
            for (tag, _), value in zip(shards, res):
                land(tag, value)
        # drain: the last bucket (every bucket, in sequential mode)
        for b in range(len(buckets)):
            if buckets[b].leaf_ids[0] in finished:
                continue
            for tag, fn in finisher_shards(b):
                land(tag, fn())

        mean_tree = tree_unflatten(stacked_tree,
                                   [finished[i] for i in range(len(leaves))])
        return mean_tree, results


def reducer_from_plan(plan, total_bytes: float,
                      group: Optional[Sequence[int]] = None,
                      mode: str = "bucketed",
                      bucket_bytes: Optional[float] = None,
                      use_kernel_add: bool = True,
                      transport: str = "peer_ring") -> OverlapGradReducer:
    """Reducer from a compiled :class:`~repro_torch.plan.Plan`.

    Two ``PlanEntry`` lookups, as the reference's ``reducer_from_plan``
    does: the octave of the *full* grad payload supplies the planned
    ``bucket_bytes``, then the octave of the bucket payload supplies the
    algorithm, rank order and chunking actually run.  The schedule is
    lowered and certified here, before any use.  A schedule that does
    not end all-reduced (bcube's lowering ends reduce-scattered) falls
    back to a certified ring at the planned rank order: the reordering
    is kept, the algorithm choice is not.  ``transport="peer_ring"``
    (the default) runs each bucket through the peer-memory ring kernel
    at that order; a plan whose schedule is not a ring (a double binary
    tree over 3 ranks) takes the same fallback, since the kernel runs
    rings only.  ``transport="runner"`` runs the planned schedule.
    """
    entry = plan.lookup("all-reduce", total_bytes, group)
    if entry is None:
        raise ValueError("the plan has no all-reduce entry for group "
                         f"{group}")
    bb = float(bucket_bytes if bucket_bytes is not None
               else (entry.bucket_bytes or total_bytes))
    entry_b = plan.lookup("all-reduce", bb, group)
    prog = entry_b.program()
    sched = ScheduleLowering().lower_schedule(prog)
    require_certified(prog, sched)
    if sched.postcondition != "allreduce" or (
            transport == "peer_ring" and sched.algorithm != "ring"):
        local = [entry_b.group.index(p) for p in entry_b.perm]
        sched = certified_allreduce(len(entry_b.group), bb, algo="ring",
                                    perm=local,
                                    chunk_factor=max(1, entry_b.chunks))
    return OverlapGradReducer(sched, bucket_bytes=bb, mode=mode,
                              use_kernel_add=use_kernel_add,
                              transport=transport)


def stacked_grads(model, params: Any, batch: Dict[str, torch.Tensor], n: int
                  ) -> Tuple[torch.Tensor, Any]:
    """Per-rank losses ``[n]`` and grads stacked ``[n, ...]`` (row r = rank r).

    The batch's leading dimension splits into n contiguous shards, and
    each virtual rank takes :func:`value_and_grad` on its own shard —
    what the reference's ``shard_map`` over the data axis computes.
    """
    rows = batch["tokens"].shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split over {n} ranks")
    per = rows // n
    stacked: Optional[List[torch.Tensor]] = None
    losses = []
    for r in range(n):
        shard = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
        loss, grads = value_and_grad(model, params, shard)
        g = tree_leaves(grads)
        if stacked is None:
            stacked = [t.new_empty((n, *t.shape)) for t in g]
        for buf, t in zip(stacked, g):
            buf[r].copy_(t)
        del grads, g
        losses.append(loss)
    return torch.stack(losses), tree_unflatten(params, stacked)


def make_overlap_train_step(model, opt_cfg, reducer: OverlapGradReducer):
    """Train step whose grad all-reduce is the reducer's certified path.

    Pure data parallelism over ``reducer.n`` virtual ranks: the stacked
    per-rank grads (:func:`stacked_grads`) go through the reducer, which
    pipelines the bucketed certified schedules over them, and AdamW
    applies the mean — the same ``apply_opt`` as the baseline step.  The
    metrics carry the mean of the per-rank losses.
    """
    def step(state: TrainState, batch: Dict[str, Any]):
        losses, gstack = stacked_grads(model, state.params,
                                       batch_on(batch, model.device), reducer.n)
        mean_grads, _ = reducer(gstack)
        del gstack
        new_params, new_opt, metrics = apply_opt(
            opt_cfg, state.params, mean_grads, state.opt)
        metrics = dict(metrics, loss=losses.mean())
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return step
