"""The tensor-parallel, ZeRO-1 train step on a ``(data, model)`` or
``(pod, data, model)`` virtual mesh.

What the reference's ``jit_train_step(..., overlap="off")`` runs under
GSPMD from ``state_pspecs`` and ``batch_pspecs``, written out:

1. each data-parallel rank (a Python loop, as
   :func:`~repro_torch.train.overlap_grads.stacked_grads` loops) takes the
   loss and its gradient on its rows through the tensor-parallel
   :meth:`DecoderLM.loss <repro_torch.models.transformer.DecoderLM.loss>`,
   its ``m`` model ranks the leading dimension of every sharded tensor,
   every model-axis sum a certified schedule
   (:class:`~repro_torch.parallel.tensor.TensorParallel`);
2. the data-parallel ranks' gradients go through an
   :class:`~repro_torch.train.overlap_grads.OverlapGradReducer` over the
   ``d`` data-parallel ranks, all ``m`` model ranks' shards in one
   payload (``peer_ring`` on the card for a ring, the runner otherwise);
3. the global-norm clip: each model rank's squares of its shards, a
   replicated leaf counted once, all-reduced over the model axis;
4. ZeRO-1: each data-parallel rank holds its slice of the AdamW moments
   (:func:`~repro_torch.parallel.sharding.zero1_spec`: the first
   unsharded dimension the dp size divides) and updates that slice of
   the parameters (``optim/adamw.py``'s arithmetic, in slices of
   ``UPDATE_ELEMS`` elements, the moments in place and the parameters
   into new tensors); the slices go back together by a certified
   all-gather over the data axis.

The state holds the parameters in model-axis storage
(:func:`~repro_torch.parallel.tensor.shard_params`) and the moments as
``[dp, ...]``, data-parallel rank ``k``'s slice in row ``k``; a leaf that
no dimension of which the dp size divides keeps whole moments.  The batch
is :func:`repro_torch.data.synthetic.make_global_batch`'s: one block of
rows a virtual rank, the step reading data-parallel rank ``k``'s rows
from the rank that holds mesh slot ``(k, 0)``.

:class:`EPTrainStep` is the MoE step on a ``(data,)``, ``(data,
model)`` or ``(pod, data, model)`` mesh with expert parallelism armed
over ``data``.  The EP
all-to-all couples the data ranks, so one autograd graph covers all of
them (:meth:`DecoderLM.loss_ranks
<repro_torch.models.transformer.DecoderLM.loss_ranks>`): each rank reads
its own leaf views of the replicated parameters (the same storage, no
copy), autograd writes each rank's gradient into row ``k`` of the stacked
buffers the data axis's reducer takes, and each rank reads its ``E/d``
experts of an expert leaf as a leaf of its own on the same storage,
whose gradient lands in its slice of one buffer: the experts' gradient
comes whole from the graph and never goes through the reducer.  The
graph's loss is the sum of the ranks' losses, so that each view's
gradient is its rank's; the experts' gradient is then ``d`` times the
mean loss's and is divided by ``d``.  On a pod axis the ``P * D`` ranks
run in the one graph, each pod's ``D`` data ranks an all-to-all of their
own; data rank ``j`` of every pod reads the same ``E/D`` experts, its
pod's gradient landing in the pod's slice of the buffer, and the ``P``
slices are summed by a certified all-reduce over the pod axis before the
division by ``P * D``.  The update runs in place, a large
leaf in slices of ``UPDATE_ELEMS`` elements (the same elementwise
arithmetic), and the ZeRO-1 all-gather runs leaf by leaf in pieces, so
that the step holds one copy of the state.  :class:`DenseMoETrainStep`,
where the data axis does not divide the experts, runs the same views
with every leaf replicated; both are :class:`RankViewTrainStep`s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import accounting
from repro_torch.optim import OptState
from repro_torch.optim.adamw import adamw_update
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.tensor import (
    TensorParallel, all_gather_rows, certified_all_gather, model_dim,
    require_tp_family, shard_params)
from repro_torch.tree import tree_leaves, tree_unflatten

from .train_step import TrainState, batch_on

__all__ = ["DenseMoETrainStep", "EPTrainStep", "RankViewTrainStep",
           "ShardedLayout", "expert_leaves", "init_sharded_state",
           "layout_state", "make_ep_train_step", "make_sharded_train_step",
           "param_shapes", "reckon_dense_moe_memory", "reckon_ep_memory"]

#: the in-place update's slice of a large leaf (f32 temporaries of 256 MB)
UPDATE_ELEMS = 1 << 26


def param_shapes(model) -> Any:
    """The model's parameter tree as meta tensors (shapes and dtypes,
    nothing allocated)."""
    from repro_torch.models.layers import map_spec

    return map_spec(model.param_spec(), lambda e: torch.empty(
        e[0], dtype=e[2] if len(e) > 2 else model.dtype, device="meta"))


def _zslice(t: torch.Tensor, dim: int, dp: int) -> torch.Tensor:
    """``[dp, ...]``: dimension ``dim`` cut into ``dp`` slices, rank first."""
    return t.unflatten(dim, (dp, t.shape[dim] // dp)).movedim(dim, 0)


def _unslice(s: torch.Tensor, dim: int) -> torch.Tensor:
    return s.movedim(0, dim).flatten(dim, dim + 1)


def _pieces(t: torch.Tensor, limit: int) -> List[torch.Tensor]:
    """Views of ``t`` of at most ``limit`` elements (slices of leading
    dimensions; a tensor of the same shape gives the same slices)."""
    if t.numel() <= limit or t.dim() == 0:
        return [t]
    if t.shape[0] == 1:
        return _pieces(t[0], limit)
    rows = max(1, limit // (t.numel() // t.shape[0]))
    return [q for s in range(0, t.shape[0], rows)
            for q in _pieces(t[s:s + rows], limit)]


@dataclasses.dataclass
class ShardedLayout:
    """Where a model's parameters and moments live on a mesh."""

    mesh: Any
    pspecs: Any                    # param_pspecs
    m: int                         # model-axis size
    dp: int                        # data-parallel ranks (pod x data)
    #: per leaf, the storage dim ZeRO-1 slices, or None
    zdims: List[Optional[int]]
    #: per leaf, the ranks its ZeRO-1 slices are over: the dp axes
    #: ``zero1_spec`` adds (``dp``, or the pods for an expert leaf already
    #: split over ``data``), 1 for a leaf with whole moments
    zn: List[int]

    @classmethod
    def of(cls, model, mesh) -> "ShardedLayout":
        shapes = param_shapes(model)
        sizes = shd.mesh_axis_sizes(mesh)
        pspecs = shd.param_pspecs(shapes, model.cfg, mesh)
        zspecs = tree_unflatten(pspecs, [
            shd.zero1_spec(s, tuple(t.shape), mesh)
            for s, t in zip(tree_leaves(pspecs), tree_leaves(shapes))])
        dp = int(np.prod([sizes[a] for a in shd.dp_axes(mesh)]))
        zdims, zn = [], []
        for ps, zs in zip(tree_leaves(pspecs), tree_leaves(zspecs)):
            moved = [i for i, (a, b) in enumerate(zip(ps, zs)) if a != b]
            # storage: a model-sharded leaf carries the model axis first
            # (a mesh without one keeps every leaf whole)
            lead = model_dim(ps) is not None and sizes.get("model", 1) > 1
            zdims.append(moved[0] + lead if moved else None)
            zn.append(int(np.prod([sizes[a] for a in shd.spec_axes(
                zs[moved[0]])])) if moved else 1)
        return cls(mesh, pspecs, sizes.get("model", 1), dp, zdims, zn)

    @property
    def shares(self) -> List[int]:
        """Per leaf, the model-axis ranks its storage is split over: ``m``
        for a leaf in model-axis storage, else 1."""
        return [self.m if model_dim(s) is not None and self.m > 1 else 1
                for s in tree_leaves(self.pspecs)]

    def counts(self) -> Dict[str, int]:
        """Leaves sharded over the model axis, replicated, and ZeRO-1
        sliced."""
        specs = tree_leaves(self.pspecs)
        sharded = sum(model_dim(s) is not None for s in specs)
        return {"sharded": sharded, "replicated": len(specs) - sharded,
                "zero1_sliced": sum(z is not None for z in self.zdims)}


def init_sharded_state(model, generator: torch.Generator,
                       layout: ShardedLayout) -> TrainState:
    """Parameters drawn from ``generator`` (the unsharded model's), held
    in model-axis storage; zero moments, ZeRO-1 sliced; step 0."""
    return layout_state(model.init(generator), layout)


def layout_state(params: Any, layout: ShardedLayout) -> TrainState:
    """The logical ``params`` held in model-axis storage, zero moments,
    ZeRO-1 sliced, and step 0, on the parameters' device (on ``meta``:
    the dry run's stand-ins, nothing allocated)."""
    params = shard_params(params, layout.pspecs, layout.m)

    def zeros(p, zd, zn):
        shape = p.shape if zd is None else _zslice(
            torch.empty(p.shape, device="meta"), zd, zn).shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    leaves = tree_leaves(params)
    m_, v_ = (tree_unflatten(params, [
        zeros(p, zd, zn) for p, zd, zn in zip(leaves, layout.zdims, layout.zn)])
        for _ in range(2))
    dev = leaves[0].device
    return TrainState(params, OptState(m_, v_, torch.zeros((), dtype=torch.int32,
                                                           device=dev)),
                      torch.zeros((), dtype=torch.int32, device=dev))


class ShardedTrainStep:
    """The step: ``step(state, batch) -> (state', metrics)``.

    ``counts`` tallies the collectives run: ``model_allreduce`` and
    ``model_allgather`` (the model axis: forward, backward, recompute and
    the clip), ``data_allgather`` (ZeRO-1's), ``data_allreduce`` (the
    reducer's calls).  The data-parallel ranks' gradients run one after
    another, so the model axis's collectives of that part report
    ``groups=dp`` (:mod:`repro_torch.kernels.accounting`).
    """

    def __init__(self, model, opt_cfg, mesh, reducer=None,
                 use_kernel_add: bool = True):
        require_tp_family(model.cfg)
        self.model, self.opt_cfg, self.mesh = model, opt_cfg, mesh
        self.layout = ShardedLayout.of(model, mesh)
        self.tp = TensorParallel(mesh, self.layout.pspecs, use_kernel_add)
        dp = self.layout.dp
        if dp > 1 and reducer is None:
            raise ValueError(f"{dp} data-parallel ranks need a reducer over "
                             f"the data axis")
        if reducer is not None and reducer.n != dp:
            raise ValueError(f"the reducer spans {reducer.n} ranks, the "
                             f"mesh's data axes {dp}")
        self.reducer = reducer
        self.gather_schedule = certified_all_gather(dp) if dp > 1 else None
        self.counts = {"model_allreduce": 0, "model_allgather": 0,
                       "data_allgather": 0, "data_allreduce": 0}

    # -- gradients ---------------------------------------------------------
    def dp_batches(self, batch: Dict[str, Any]) -> List[Dict[str, torch.Tensor]]:
        """Data-parallel rank ``k``'s rows: those of the rank that holds
        mesh slot ``(k, 0)`` (``make_global_batch``'s ``[n, rows, S]``)."""
        m, order = self.layout.m, self.mesh.order
        return [batch_on({k: v[order[i * m]] for k, v in batch.items()},
                         self.model.device) for i in range(self.layout.dp)]

    def value_and_grad(self, params: Any, batch: Dict[str, Any]
                       ) -> Tuple[torch.Tensor, Any]:
        """The loss (mean over the data-parallel ranks) and the mean
        gradient in model-axis storage, after the data-axis all-reduce."""
        shards = self.dp_batches(batch)
        losses, stacked = [], None
        self.tp.groups = len(shards)
        try:
            for k, shard in enumerate(shards):
                leaves = [p.detach().requires_grad_()
                          for p in tree_leaves(params)]
                with torch.enable_grad():
                    loss = self.model.loss(tree_unflatten(params, leaves),
                                           shard, tp=self.tp)
                grads = torch.autograd.grad(loss, leaves)
                losses.append(loss.detach())
                if len(shards) == 1:
                    stacked = list(grads)
                    break
                if stacked is None:
                    stacked = [g.new_empty((len(shards), *g.shape))
                               for g in grads]
                for buf, g in zip(stacked, grads):
                    buf[k].copy_(g)
                del grads
        finally:
            self.tp.groups = 1
        tree = tree_unflatten(params, stacked)
        if len(shards) > 1:
            tree, _ = self.reducer(tree, shares=self.layout.shares)
            self.counts["data_allreduce"] += 1
        return torch.stack(losses).mean(), tree

    # -- the update ----------------------------------------------------------
    @torch.no_grad()
    def apply(self, state: TrainState, grads: Any) -> Tuple[TrainState, dict]:
        """Clip, ZeRO-1 AdamW on each data-parallel rank's slice, and the
        slices all-gathered over the data axis.  The update runs in pieces
        of ``UPDATE_ELEMS`` (no f32 copy of a whole leaf): the moments in
        place, each parameter into a new tensor."""
        cfg, dp = self.opt_cfg, self.layout.dp
        gnorm = self.tp.global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        count = state.opt.count + 1
        lr = cfg.schedule(count) if cfg.schedule is not None else cfg.lr
        b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
        b2c = 1.0 - cfg.b2 ** count.to(torch.float32)
        zdims, new_p = self.layout.zdims, []
        sliced: Dict[torch.dtype, List[int]] = {}
        for i, (p, g, m_, v_) in enumerate(zip(
                tree_leaves(state.params), tree_leaves(grads),
                tree_leaves(state.opt.m), tree_leaves(state.opt.v))):
            q = torch.empty_like(p)
            views = (p, g, q)
            if zdims[i] is not None:
                views = tuple(_zslice(t, zdims[i], dp) for t in views)
                sliced.setdefault(p.dtype, []).append(i)
            for a, b, out, c, e in zip(*(_pieces(t, UPDATE_ELEMS)
                                         for t in (*views, m_, v_))):
                for dst, src in zip((out, c, e), adamw_update(
                        cfg, a, b, c, e, scale, lr, b1c, b2c)):
                    dst.copy_(src)
            new_p.append(q)
        for ids in sliced.values():
            self._gather([_zslice(new_p[i], zdims[i], dp) for i in ids],
                         [self.layout.shares[i] for i in ids])
        metrics = {"grad_norm": gnorm,
                   "lr": torch.as_tensor(lr, dtype=torch.float32,
                                         device=gnorm.device)}
        opt = OptState(state.opt.m, state.opt.v, count)
        return TrainState(tree_unflatten(state.params, new_p), opt,
                          state.step + 1), metrics

    def _gather(self, slices: List[torch.Tensor], shares: List[int]) -> None:
        """Every data-parallel rank's ``[dp, ...]`` slices (views of the new
        parameters), gathered in place by one certified all-gather over the
        data axis (one payload a dtype), which the runner runs in column
        pieces of ``UPDATE_ELEMS`` a rank (the virtual mesh holds every
        rank's gathered copy of a piece); ``shares``:
        :attr:`ShardedLayout.shares` of the slices' leaves."""
        if self.gather_schedule is None:
            return
        dp = self.layout.dp
        flat = torch.cat([s.reshape(dp, -1) for s in slices], dim=1)
        for c in range(0, flat.shape[1], UPDATE_ELEMS):
            cols = slice(c, c + UPDATE_ELEMS)
            flat[:, cols] = all_gather_rows(flat[:, cols].contiguous(),
                                            self.gather_schedule)
        self.counts["data_allgather"] += 1
        accounting.collective("all-gather", lambda: sum(
            s.numel() // k for s, k in zip(slices, shares))
            * flat.element_size())
        off = 0
        for s in slices:
            w = s[0].numel()
            s.copy_(flat[:, off:off + w].reshape(s.shape))
            off += w

    def __call__(self, state: TrainState, batch: Dict[str, Any]):
        before = dict(self.tp.counts)
        loss, grads = self.value_and_grad(state.params, batch)
        new_state, metrics = self.apply(state, grads)
        self.counts["model_allreduce"] += self.tp.counts["allreduce"] - before["allreduce"]
        self.counts["model_allgather"] += self.tp.counts["allgather"] - before["allgather"]
        return new_state, dict(metrics, loss=loss)


def make_sharded_train_step(model, opt_cfg, mesh, reducer=None,
                            use_kernel_add: bool = True) -> ShardedTrainStep:
    """The tensor-parallel, ZeRO-1 step of ``model`` on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.PlannedMesh` with a ``model`` axis of
    2 or more); ``reducer`` the data axis's all-reduce when it has more
    than one rank.  Its state comes from :func:`init_sharded_state`."""
    return ShardedTrainStep(model, opt_cfg, mesh, reducer, use_kernel_add)


def expert_leaves(params: Any) -> List[bool]:
    """Per leaf (flatten order): one of the routed experts' ``w1``/``w3``/
    ``w2`` (the shared experts' are not)."""
    flags = shd.map_with_path(
        lambda keys, _: "moe" in keys and "shared" not in keys
        and keys[-1] in ("w1", "w3", "w2"), params)
    return [bool(f) for f in tree_leaves(flags)]


class RankViewTrainStep(ShardedTrainStep):
    """The MoE step over per-rank leaf views on a ``(data,)``, ``(data,
    model)`` or ``(pod, data, model)`` mesh: ``step(state, batch) ->
    (state', metrics)``, the state :func:`init_sharded_state`'s.  One
    graph covers the ``P * D`` data-parallel ranks, each rank reading its
    own view of every leaf; ``expert`` flags (flatten order) the leaves of
    which each rank reads its ``E/D`` experts (EP: rank ``p * D + j``
    reads data rank ``j``'s), the others being replicated, their ``P * D``
    gradients through the data axes' reducer.  On a pod axis an expert
    leaf's gradient buffer holds one slice a pod, which the pod axis's
    own certified all-reduce (:attr:`pod_reducer`, built as the data
    axes' reducer is: a ring over the ``P`` pod slots) sums; its ZeRO-1
    slices are over the pods (``zero1_spec``), all-gathered over the pod
    axis after the update.  :class:`EPTrainStep` and
    :class:`DenseMoETrainStep` are its two constructions, each checking
    its own preconditions.

    ``counts`` tallies the collectives as :class:`ShardedTrainStep`'s,
    ``model_reducescatter`` (the experts' gradients over the model axis),
    and on a pod axis ``pod_allreduce`` and ``pod_allgather``.
    """

    def __init__(self, model, opt_cfg, mesh, reducer, use_kernel_add: bool,
                 expert: List[bool]):
        from .overlap_grads import OverlapGradReducer, certified_allreduce

        sizes = shd.mesh_axis_sizes(mesh)
        self.d, self.pods = sizes.get("data", 1), sizes.get("pod", 1)
        self.model, self.opt_cfg, self.mesh = model, opt_cfg, mesh
        self.layout = ShardedLayout.of(model, mesh)
        self.tp = (TensorParallel(mesh, self.layout.pspecs, use_kernel_add)
                   if self.layout.m > 1 else None)
        self.expert = expert
        dp = self.layout.dp
        if reducer is None or reducer.n != dp:
            raise ValueError(f"the MoE step needs a reducer over the {dp} "
                             f"data-parallel ranks")
        self.reducer = reducer
        self.gather_schedule = certified_all_gather(dp)
        self.counts = {"model_allreduce": 0, "model_allgather": 0,
                       "model_reducescatter": 0, "data_allgather": 0,
                       "data_allreduce": 0}
        self.pod_reducer = self.pod_gather = None
        if self.pods > 1 and any(expert):
            self.pod_reducer = OverlapGradReducer(
                certified_allreduce(self.pods, reducer.bucket_bytes, "ring"),
                bucket_bytes=reducer.bucket_bytes, mode=reducer.mode,
                use_kernel_add=reducer.use_kernel_add,
                transport=reducer.transport)
            self.pod_gather = certified_all_gather(self.pods)
            self.counts.update(pod_allreduce=0, pod_allgather=0)

    def replicated(self, tree: Any) -> List[Any]:
        """The leaves the data axis's all-reduce carries: all but the
        experts'."""
        return [t for t, e in zip(tree_leaves(tree), self.expert) if not e]

    def value_and_grad(self, params: Any, batch: Dict[str, Any]
                       ) -> Tuple[torch.Tensor, Any]:
        """The loss (mean over the data-parallel ranks) and its gradient:
        the replicated leaves' through the data axes' reducer, the
        experts' from the one graph (summed over the pods by the pod
        axis's reducer), divided by the ``P * D`` ranks."""
        shards = self.dp_batches(batch)
        n, pods = len(shards), self.pods
        leaves = tree_leaves(params)
        # gradient buffers: [n, ...] for a replicated leaf; an expert leaf
        # its own shape, a slice a pod on a pod axis (each rank's slice of
        # its pod's its own experts')
        lead = {False: (n,), True: (pods,) if pods > 1 else ()}
        bufs = {i: torch.zeros((*lead[e], *p.shape), dtype=p.dtype,
                               device=p.device)
                for i, (p, e) in enumerate(zip(leaves, self.expert))}
        views = []
        for r in range(n):
            pod, j = divmod(r, self.d)
            lv = []
            for i, p in enumerate(leaves):
                if self.expert[i]:
                    # rank r reads data rank j's E/D experts: a leaf of
                    # its own on the same storage, its gradient a slice of
                    # its pod's buffer
                    v = self._experts_of(p.detach(), j).requires_grad_()
                    v.grad = self._experts_of(
                        bufs[i][pod] if pods > 1 else bufs[i], j)
                else:
                    v = p.detach().requires_grad_()
                    v.grad = bufs[i][r]
                lv.append(v)       # backward accumulates in place
            views.append(tree_unflatten(params, lv))
        if self.tp is not None:
            self.tp.groups = n
        try:
            with torch.enable_grad():
                losses = self.model.loss_ranks(views, shards, tp=self.tp)
                torch.stack(losses).sum().backward()
        finally:
            if self.tp is not None:
                self.tp.groups = 1
        del views
        kept = [i for i, e in enumerate(self.expert) if not e]
        mean, _ = self.reducer([bufs[i] for i in kept],
                               shares=[self.layout.shares[i] for i in kept])
        self.counts["data_allreduce"] += 1
        grads = dict(zip(kept, mean))
        experts = [i for i, e in enumerate(self.expert) if e]
        if pods > 1 and experts:
            # the pods' slices summed over the pod axis (their mean, then
            # over the data ranks): one rank's row is its E/D experts
            got, _ = self.pod_reducer(
                [bufs.pop(i) for i in experts],
                shares=[self.layout.shares[i] * self.d for i in experts])
            self.counts["pod_allreduce"] += 1
            grads.update({i: g.div_(self.d) for i, g in zip(experts, got)})
        else:
            grads.update({i: bufs[i].div_(n) for i in experts})
        del bufs
        return torch.stack(losses).detach().mean(), tree_unflatten(
            params, [grads[i] for i in range(len(leaves))])

    def _experts_of(self, t: torch.Tensor, j: int) -> torch.Tensor:
        """Data rank ``j``'s ``E/D`` experts of an expert leaf (stacked
        ``[L, E, ...]``, or ``[m, L, E, ...]`` in model-axis storage)."""
        dim = 1 + (self.tp is not None)
        e_loc = t.shape[dim] // self.d
        return t.narrow(dim, j * e_loc, e_loc)

    def _norm(self, grads: Any) -> torch.Tensor:
        """The clip's global norm, each leaf once, summed in slices of
        ``UPDATE_ELEMS`` (no f32 copy of a whole expert leaf)."""
        if self.tp is not None:
            return self.tp.global_norm(grads)
        total = None
        for g in tree_leaves(grads):
            for piece in _pieces(g, UPDATE_ELEMS):
                sq = torch.sum(torch.square(piece.float()))
                total = sq if total is None else total + sq
        return torch.sqrt(total)

    @torch.no_grad()
    def apply(self, state: TrainState, grads: Any) -> Tuple[TrainState, dict]:
        """Clip (the experts counted once), the ZeRO-1 AdamW on each
        rank's slice, in place, and the slices all-gathered leaf by leaf:
        over the data axes, or over the pod axis for an expert leaf whose
        moments the pods slice."""
        cfg = self.opt_cfg
        gnorm = self._norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        count = state.opt.count + 1
        lr = cfg.schedule(count) if cfg.schedule is not None else cfg.lr
        b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
        b2c = 1.0 - cfg.b2 ** count.to(torch.float32)
        params, sliced = tree_leaves(state.params), []
        zd, zn = self.layout.zdims, self.layout.zn
        for i, (p, g, m_, v_) in enumerate(zip(
                params, tree_leaves(grads), tree_leaves(state.opt.m),
                tree_leaves(state.opt.v))):
            if zd[i] is not None:
                zp, zg = _zslice(p, zd[i], zn[i]), _zslice(g, zd[i], zn[i])
                parts = [(zp[k], zg[k], m_[k], v_[k]) for k in range(zn[i])]
                sliced.append(i)
            else:
                parts = [(p, g, m_, v_)]
            for part in parts:
                for a, b, c, e in zip(*(_pieces(t, UPDATE_ELEMS) for t in part)):
                    new = adamw_update(cfg, a, b, c, e, scale, lr, b1c, b2c)
                    for dst, src in zip((a, c, e), new):
                        dst.copy_(src)
        for i in sliced:
            pod = self.expert[i] and self.pods > 1
            share = self.layout.shares[i] * (self.d if pod else 1)
            params[i].copy_(_unslice(self._gather_leaf(
                _zslice(params[i], zd[i], zn[i]), share, pod), zd[i]))
        metrics = {"grad_norm": gnorm,
                   "lr": torch.as_tensor(lr, dtype=torch.float32,
                                         device=gnorm.device)}
        opt = OptState(state.opt.m, state.opt.v, count)
        return TrainState(state.params, opt, state.step + 1), metrics

    def _gather_leaf(self, s: torch.Tensor, share: int, pod: bool = False
                     ) -> torch.Tensor:
        """One leaf's ``[n, ...]`` updated slices, gathered by the
        certified all-gather over the data axes (``n = P * D``) or, with
        ``pod``, over the pod axis (``n = P``), in pieces of at most
        ``UPDATE_ELEMS`` elements a rank (the runner holds ``n + 1`` rows
        of a piece a rank); ``share``: the ranks of a real mesh whose
        pieces one row holds (the leaf's :attr:`ShardedLayout.shares`,
        times ``D`` for an expert leaf's pod slices)."""
        sched, key = ((self.pod_gather, "pod_allgather") if pod else
                      (self.gather_schedule, "data_allgather"))
        flat = s.reshape(sched.n, -1)
        got = torch.empty_like(flat)
        for c in range(0, flat.shape[1], UPDATE_ELEMS):
            cols = slice(c, c + UPDATE_ELEMS)
            piece = flat[:, cols].contiguous()
            got[:, cols] = all_gather_rows(piece, sched)
            self.counts[key] += 1
            accounting.collective("all-gather", lambda: piece.numel()
                                  // share * piece.element_size())
        return got.reshape(s.shape)

    def __call__(self, state: TrainState, batch: Dict[str, Any]):
        before = dict(self.tp.counts) if self.tp is not None else {}
        loss, grads = self.value_and_grad(state.params, batch)
        new_state, metrics = self.apply(state, grads)
        if self.tp is not None:
            for kind in ("allreduce", "allgather", "reducescatter"):
                self.counts[f"model_{kind}"] += (self.tp.counts.get(kind, 0)
                                                 - before.get(kind, 0))
        return new_state, dict(metrics, loss=loss)


class EPTrainStep(RankViewTrainStep):
    """The MoE step with the EP all-to-all armed over the data axis
    (:func:`repro_torch.launch.specs.configure_sp`), which divides the
    experts: each data rank reads its ``E/d`` experts, whose gradient
    comes whole from the graph; the reducer carries the replicated
    leaves only."""

    def __init__(self, model, opt_cfg, mesh, reducer=None,
                 use_kernel_add: bool = True):
        from repro_torch.parallel import moe_a2a

        cfg = model.cfg
        if not cfg.n_experts:
            raise ValueError(f"{cfg.name} has no experts: the EP step "
                             f"trains MoE models")
        moe_a2a._check_axes(mesh, "data")
        sizes = shd.mesh_axis_sizes(mesh)
        d, m = sizes.get("data", 1), sizes.get("model", 1)
        if m > 1:
            require_tp_family(cfg)
        if d < 2 or cfg.n_experts % d:
            raise ValueError(f"EP over {d} data-parallel ranks cannot split "
                             f"{cfg.name}'s {cfg.n_experts} experts")
        state = moe_a2a._EP_STATE
        if state["mesh"] is not mesh or state["ep"] != "data":
            raise ValueError("arm EP over this mesh's data axis first "
                             "(launch.specs.configure_sp)")
        super().__init__(model, opt_cfg, mesh, reducer, use_kernel_add,
                         expert_leaves(param_shapes(model)))


class DenseMoETrainStep(RankViewTrainStep):
    """The MoE step where the data axis does not divide the experts: the
    reference's fallback.  Its ``arm_ep`` arms the mesh but ``ep_armed``
    is false, so ``moe_layer`` runs ``moe_dense`` on the global batch.
    Here the MoE blocks run the dense dispatch on each data rank's rows in
    one graph over the ranks
    (:func:`~repro_torch.models.layers.moe_dense_ranks`, the routing
    shares averaged over the ranks, so the aux loss is the global
    batch's); every leaf, the experts' included, is replicated, and its
    ``d`` gradients go through the data axis's reducer.
    :func:`reckon_dense_moe_memory` is its device memory."""

    def __init__(self, model, opt_cfg, mesh, reducer=None,
                 use_kernel_add: bool = True):
        from repro_torch.parallel import moe_a2a

        cfg = model.cfg
        if not cfg.n_experts:
            raise ValueError(f"{cfg.name} has no experts")
        if cfg.moe_impl == "scatter":
            raise ValueError(f"{cfg.name}'s sort-based dispatch sizes its "
                             f"capacity over the whole batch; the data-"
                             f"parallel MoE step runs the dense dispatch")
        if moe_a2a.ep_armed(cfg):
            raise ValueError("EP is armed over a data axis that divides the "
                             "experts: that mesh runs EPTrainStep")
        moe_a2a._check_axes(mesh, "data")
        if shd.mesh_axis_sizes(mesh).get("model", 1) > 1:
            require_tp_family(cfg)
        super().__init__(model, opt_cfg, mesh, reducer, use_kernel_add,
                         [False] * len(tree_leaves(param_shapes(model))))


def reckon_dense_moe_memory(shapes: Any, d: int, bucket_bytes: float
                            ) -> Dict[str, int]:
    """:class:`DenseMoETrainStep`'s device bytes from the parameter shapes
    (a reckoning, nothing measured; activations not counted): the
    weights, the f32 AdamW moments, the ``d`` ranks' gradient buffers,
    their mean, and the gradients in flight.  A stacked leaf reaches each
    rank's graph through one split into layers, whose backward runs after
    every block's, so autograd holds every rank's gradients of the
    stacked leaves before they are added into the buffers; then the
    reducer's copy of a bucket's rows where it joins leaves, and the
    ring's reduced row.  AdamW's f32 temporaries of one slice of
    ``UPDATE_ELEMS`` come after the flight."""
    from .overlap_grads import partition_tree

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    leaves = tree_leaves(shapes)
    n = sum(t.numel() for t in leaves)
    w = nbytes(shapes)
    bucket = max((d * b.n_bytes if len(b.leaf_ids) > 1 else 0) + b.n_bytes
                 for b in partition_tree(leaves, bucket_bytes))
    largest = max(t.numel() for t in leaves)
    in_flight = max(d * nbytes(shapes["blocks"]) + bucket,
                    7 * 4 * min(UPDATE_ELEMS, largest))
    out = {"params": n, "weights": w, "moments": 8 * n, "gradients": d * w,
           "mean": w, "in_flight": in_flight}
    out["total"] = w + 8 * n + d * w + w + in_flight
    return out


def reckon_ep_memory(shapes: Any, d: int, pods: int = 1) -> Dict[str, int]:
    """:class:`EPTrainStep`'s device bytes from the parameter shapes (a
    reckoning, nothing measured; activations not counted): the weights,
    the f32 AdamW moments, the experts' gradient buffers (one a pod: on a
    pod axis each pod's ranks write their experts' gradients into a
    buffer of their own), the replicated leaves' gradient on each of the
    ``pods * d`` ranks, and the means the reducers return: the replicated
    leaves', and on a pod axis the experts'."""
    leaves = list(zip(tree_leaves(shapes), expert_leaves(shapes)))
    n = sum(t.numel() for t, _ in leaves)
    w = sum(t.numel() * t.element_size() for t, _ in leaves)
    ex = sum(t.numel() * t.element_size() for t, e in leaves if e)
    out = {"params": n, "weights": w, "moments": 8 * n,
           "expert_gradients": pods * ex,
           "replicated_gradients": pods * d * (w - ex),
           "mean": w - ex + (ex if pods > 1 else 0)}
    out["total"] = sum(out[k] for k in ("weights", "moments",
                                        "expert_gradients",
                                        "replicated_gradients", "mean"))
    return out


def make_ep_train_step(model, opt_cfg, mesh, reducer,
                       use_kernel_add: bool = True) -> EPTrainStep:
    """The MoE model's EP step on ``mesh`` (EP armed over its data axis,
    :func:`repro_torch.launch.specs.configure_sp`), ``reducer`` the data
    axis's all-reduce of the replicated leaves.  Its state comes from
    :func:`init_sharded_state` and is updated in place."""
    return EPTrainStep(model, opt_cfg, mesh, reducer, use_kernel_add)
