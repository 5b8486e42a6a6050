"""Expert-parallel MoE over an explicit all-to-all (counterpart of
``repro.parallel.moe_a2a``).

The reference's weight-gathered EP design, on the port's virtual mesh:

1. the tokens stay where they are: the batch is split over the ``n_ep``
   data (EP) ranks, and under a model axis of ``m`` each model rank
   routes its ``S/m`` slice of its data rank's rows (the whole sequence
   where ``m`` does not divide ``S``, the reference's ``s_ok``); routing
   is local to a shard;
2. each (token, k) choice is packed into a capacity-bounded ``[n_ep, C,
   D]`` buffer (``C`` from the shard's own token count), which the EP
   all-to-all delivers over the data axis inside each model column: a
   certified ``all_to_all`` schedule (:func:`_lowered_a2a`) whose rounds
   walk the plan's solved shift ring (:func:`arm_ep`), executed by
   :func:`repro_torch.kernels.schedule_runner.run_schedule` as index
   gathers — the communication pattern the paper's ``AllToAllCost``
   prices; the model columns' buffers travel in one run;
3. every received token runs its expert's whole FFN on the rank that
   holds the expert (``E / n_ep`` experts a data rank).  Under a model
   axis the experts' ``w1``/``w3`` (``P(data, None, model)``), ``w2``
   (``P(data, model, None)``) and the shared experts' are gathered over
   ``model`` to full ``d_ff`` by the certified all-gather of
   :meth:`~repro_torch.parallel.tensor.TensorParallel.gather_each`, whose
   backward is a certified reduce-scatter; the router reaches every
   column through the conjugate identity (its gradient all-reduced over
   ``model``);
4. the results go back by a second all-to-all and are combined, weighted,
   at the source; under a model axis the columns' outputs go back
   together along S by a certified all-gather, into the replicated
   activation the tensor-parallel blocks hold once.

Gradients flow through the routing, the packing, the schedule's index
gathers (an all-to-all's transpose is the all-to-all with the pieces sent
back, which the gathers' own backward is) and the combine.  The aux loss
is the mean of every shard's, over the data ranks and, under a model axis,
over the columns too (ROADMAP.md §3: the reference's ``pmean`` over the
EP axis alone leaves the columns' values apart under ``out_specs=P()``).

On a ``(pod, data, model)`` mesh the batch runs over ``(pod, data)`` and
the experts are split over ``data`` and replicated over ``pod``, as the
reference's ``dp = ("pod",)`` lays them out (``moe_a2a.py:66,199-203``):
each pod's ``D`` data ranks run their own certified all-to-all, ``P`` of
them one after another on the virtual mesh, and data rank ``j`` of every
pod holds the same ``E/D`` experts (the train step sums their gradients
over the pod axis).  The aux loss is the mean over every shard of every
pod (ROADMAP.md §3: the reference's ``pmean`` over ``data`` leaves the
pods' values apart).  Any axis other than ``pod``, ``data`` and
``model`` is refused.

:func:`moe_a2a` takes the global batch and one parameter tree (serving,
and a layer on its own); :func:`moe_ranks` takes each data rank's rows and
its own view of the parameters, so that one autograd graph over all data
ranks hands each rank its own gradient of the replicated leaves (the EP
train step, :mod:`repro_torch.train.sharded_step`).  Both record two
``all-to-all`` records a forward call, as the reference does at trace
time; a backward pass, and a checkpoint's recompute within it, records
nothing.

Over a mesh of processes (``make_planned_mesh(..., group=...)``) each
process is one EP rank (:func:`ep_rank`): it routes its batch block,
holds its ``E / n_ep`` experts (or all of them, and uses its own), and
both all-to-alls run the same certified schedule through
:func:`repro_torch.kernels.group_runner.run_schedule_group`, so its block
of the result is the virtual mesh's bit for bit.  Under grad each
all-to-all is an autograd Function whose backward runs the same schedule
on the cotangent: each process gets the gradient of its own experts, and
its own rank's gradient of the router and input (summing those is the
data axis's all-reduce).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import accounting, schedule_runner

__all__ = ["arm_ep", "clear_ep", "ep_armed", "ep_rank", "ep_stats",
           "moe_a2a", "moe_ranks", "reset_ep_stats", "whole_weights"]

_EP_STATE: Dict[str, Any] = {"mesh": None, "ep": None, "tp": None,
                             "a2a_order": None}

#: drops counted over forward calls (never in a backward pass)
_STATS: Dict[str, Any] = {}

#: the parameter leaves' logical ranks (the storage has one more where
#: the model axis shards it), and the dimension the model axis shards
_EXPERT_DIM = {"w1": 2, "w3": 2, "w2": 1}
_SHARED_DIM = {"w1": 1, "w3": 1, "w2": 0}


def arm_ep(mesh, ep_axis: str = "data", tp_axis: Optional[str] = "model",
           plan=None, session=None) -> None:
    """Arm expert parallelism over ``mesh`` (a
    :class:`~repro_torch.launch.mesh.PlannedMesh`, virtual or over a
    process group); ``plan`` (a
    :class:`repro_torch.plan.Plan`), or ``session``'s compiled plan, may
    supply the shift-ring order of the EP all-to-all.

    When the plan has an ``all-to-all`` entry whose group size equals the
    EP degree (the largest payload among them), its solved rank order
    becomes the order in which the shift schedule walks peers, in EP
    axis-index space: on a planned mesh axis index ``i`` holds node
    ``mesh_plan.flat[i]``, so the entry's node order is composed with
    that placement; without a mesh plan, the entry's local permutation is
    the order.  ``tp_axis`` names the axis the experts are gathered over.
    """
    if plan is None and session is not None:
        plan = session.planned
    ep = ep_axis if ep_axis in mesh.axis_names else None
    order = None
    if plan is not None and ep is not None:
        n_ep = mesh.axis_size(ep)
        # the largest payload bucket: the multi-MB EP shuffle is the one
        # worth ordering for
        cands = [e for (op, _b, grp), e in plan.entries.items()
                 if op == "all-to-all" and len(grp) == n_ep]
        entry = max(cands, key=lambda e: e.size_bytes) if cands else None
        if entry is not None:
            if plan.mesh_plan is not None:
                flat = plan.mesh_plan.flat
                if flat.size == n_ep and set(map(int, flat)) == set(entry.group):
                    pos = {int(node): i for i, node in enumerate(flat)}
                    order = tuple(pos[int(node)] for node in entry.perm)
                # else: axis indices do not map 1:1 onto plan nodes (a
                # multi-axis mesh): the identity shift ring
            else:
                order = tuple(int(i) for i in entry.local_perm)
    tp = tp_axis if tp_axis and tp_axis in mesh.axis_names else None
    _EP_STATE.update(mesh=mesh, ep=ep, tp=tp, a2a_order=order)


def clear_ep() -> None:
    _EP_STATE.update(mesh=None, ep=None, tp=None, a2a_order=None)


def ep_armed(cfg: ModelConfig) -> bool:
    """An EP mesh is armed and its degree divides the experts."""
    m = _EP_STATE["mesh"]
    if m is None or _EP_STATE["ep"] is None:
        return False
    return cfg.n_experts % m.axis_size(_EP_STATE["ep"]) == 0


def reset_ep_stats() -> None:
    _STATS.clear()


def ep_stats() -> Dict[str, int]:
    """The (token, k) choices routed by the layers' forward calls since
    :func:`reset_ep_stats`, and those dropped at the source (a
    destination rank's buffer full) and at the destination (a local
    expert's slots full; the buffers' empty slots, which the receiver
    also queues, not counted)."""
    return {k: int(v) for k, v in _STATS.items()}


def _count(key: str, value) -> None:
    _STATS[key] = _STATS.get(key, 0) + value


class _TallyBackward(torch.autograd.Function):
    """The identity, whose backward reports the all-to-all that carries
    the cotangents back to their senders
    (:mod:`repro_torch.kernels.accounting`)."""

    @staticmethod
    def forward(ctx, x, n_bytes, groups):
        ctx.n_bytes, ctx.groups = n_bytes, groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        accounting.collective("all-to-all", lambda: ctx.n_bytes, ctx.groups)
        return g, None, None


def _in_backward() -> bool:
    """A backward pass is running (a checkpoint's recompute included)."""
    return torch._C._current_graph_task_id() != -1


@functools.lru_cache(maxsize=64)
def _lowered_a2a(n: int, order: Optional[Tuple[int, ...]]):
    """The certified lowering of the shift-scheduled all-to-all over
    ``order``: an ``all_to_all`` Program with ``order`` applied as the
    permutation pass, lowered by
    :class:`~repro_torch.collective.ScheduleLowering` (the reference's
    ``JaxExecutor.lower``) and proved against its program by
    :func:`repro_torch.analysis.require_certified` before any run."""
    from repro_torch.analysis import require_certified
    from repro_torch.collective import (
        CollectiveOp, ScheduleLowering, apply_permutation, compile_op)

    if order is None:
        order = tuple(range(n))
    if sorted(order) != list(range(n)):
        raise ValueError(f"bad shift order {order}")
    prog = compile_op(CollectiveOp("all_to_all", float(n), range(n)),
                      "all_to_all")
    low = ScheduleLowering().lower(apply_permutation(prog, order))
    require_certified(low.program, low.schedule)
    return low


def _shift_perms(n: int, order: Optional[Tuple[int, ...]] = None):
    """Per-round ``(src, dst)`` pairs of the shift-scheduled all-to-all
    over the ring ``order`` (``order[pos] = shard``): round k pairs every
    shard with the peer k steps ahead along that ring; the identity order
    is the classic ``i -> i+k`` shift.  The list-of-pairs view of
    :func:`_lowered_a2a`."""
    low = _lowered_a2a(n, None if order is None else tuple(order))
    return [list(rnd) for rnd in low.shift_rounds]


def _a2a_shift(x: torch.Tensor, n: int,
               order: Optional[Tuple[int, ...]] = None,
               share: int = 1, groups: int = 1) -> torch.Tensor:
    """The all-to-all over the virtual mesh: ``x [n, n, ...]`` — rank
    ``i``'s piece ``j`` is addressed to rank ``j`` — to ``[n, n, ...]``
    with rank ``d``'s piece ``s`` received from rank ``s``.  It is
    reported to an open :class:`~repro_torch.kernels.accounting.
    KernelWork`, forward, recompute and backward alike, as one rank's
    result, its row over ``share`` (the model ranks whose columns a row
    holds), one of ``groups`` (the pods whose all-to-alls run one after
    another).

    The certified schedule of :func:`_lowered_a2a` runs through
    :func:`~repro_torch.kernels.schedule_runner.run_schedule` (its
    ``addressed`` init: a rank's row is its n outgoing pieces; a round is
    one index gather of the pieces in flight).  Under autograd the
    gathers' backward sends every piece's cotangent back to its sender.
    """
    sched = _lowered_a2a(n, None if order is None else tuple(order)).schedule
    out = schedule_runner.run_schedule(x.reshape(n, -1), sched)
    # out[d, s * n + d]: the piece s sent to d
    pick = torch.arange(n, device=x.device)
    got = out.reshape(n, n, n, -1)[pick[:, None], pick[None, :], pick[:, None]]
    if accounting.counting():
        n_bytes = x[0].numel() // share * x.element_size()
        accounting.collective("all-to-all", lambda: n_bytes, groups)
        if got.requires_grad:
            got = _TallyBackward.apply(got, n_bytes, groups)
    return got.reshape(x.shape)


def _route(p, xl: torch.Tensor, cfg: ModelConfig, n_ep: int, C: int):
    """One shard's routing and packing (``moe_a2a.py:227-262``): its
    ``[n_ep * C, D]`` send buffer, the local expert of every slot (-1 for
    an empty slot), what the combine needs, and the shard's aux loss."""
    from repro_torch.models.layers import _pack, _router_probs

    K = cfg.moe_top_k
    E_loc = cfg.n_experts // n_ep
    Bl, S, D = xl.shape
    T = Bl * S
    tok = torch.arange(T, device=xl.device).repeat_interleave(K)
    xf = xl.reshape(T, D)
    idx, w, aux = _router_probs(p, xf, cfg)
    dest = (idx // E_loc).reshape(-1)
    local_e = (idx % E_loc).reshape(-1)
    order, keep, slot = _pack(dest, n_ep, C)
    send_x = xf.new_zeros((n_ep * C, D)).index_add(
        0, slot, torch.where(keep[:, None], xf[tok[order]], 0))
    # the reference's ids add into zeros (0 in an empty slot); carrying
    # id + 1 and taking 1 off marks the empty slots -1 for the drop count
    send_e = torch.zeros(n_ep * C, dtype=torch.int64,
                         device=xl.device).index_add(
        0, slot, torch.where(keep, local_e[order] + 1, 0)) - 1
    slot_of = torch.full((T * K,), -1, dtype=torch.int64, device=xl.device)
    slot_of[order] = torch.where(keep, slot, -1)
    if not _in_backward():
        _count("choices", T * K)
        _count("source_drops", (~keep).sum())
    return send_x, send_e, (xf, w.reshape(-1).to(xl.dtype), slot_of), aux


def _expert_pass(w: Dict[str, torch.Tensor], rx: torch.Tensor,
                 re: torch.Tensor, cfg: ModelConfig, E_loc: int) -> torch.Tensor:
    """One rank's experts (``w``: their ``w1``/``w3``/``w2`` at full
    ``d_ff``) on the ``[T2, D]`` tokens it received (``re``: their local
    experts, -1 in an empty slot, which queues at expert 0 as the
    reference's zero does), packed by expert with capacity, and the
    results back in arrival order (``moe_a2a.py:272-293``)."""
    from repro_torch.models.layers import _experts, _pack

    T2, D = rx.shape
    C2 = max(int(math.ceil(T2 / E_loc * cfg.capacity_factor)), 1)
    order2, keep2, slot2 = _pack(re.clamp_min(0), E_loc, C2)
    if not _in_backward():
        _count("destination_drops", ((re[order2] >= 0) & ~keep2).sum())
    xin = rx.new_zeros((E_loc * C2, D)).index_add(
        0, slot2, torch.where(keep2[:, None], rx[order2], 0))
    xout = _experts(w, xin.reshape(E_loc, C2, D), "").reshape(-1, D)
    return rx.new_zeros((T2, D)).index_add(
        0, order2, torch.where(keep2[:, None], xout[slot2], 0))


def _combine(p, got: torch.Tensor, routed, shape) -> torch.Tensor:
    """The return trip's results weighted and summed at the source, plus
    the shared experts (``moe_a2a.py:296-308``).

    A token's K choices are added in choice order, one add at a time: the
    scatter-add over ``tok`` (the reference's ``.at[tok].add``) as the CPU
    runs it, without the card's atomics, whose order, and so whose
    rounding, changes from run to run.
    """
    from repro_torch.models.layers import mlp

    xf, wk, slot_of = routed
    contrib = torch.where((slot_of >= 0)[:, None],
                          got[slot_of.clamp_min(0)], 0)
    parts = (contrib * wk[:, None]).reshape(xf.shape[0], -1, xf.shape[1])
    y = parts[:, 0]
    for k in range(1, parts.shape[1]):
        y = y + parts[:, k]
    if "shared" in p:
        y = y + mlp(p["shared"], xf)
    return y.reshape(shape)


def _record(B: int, S: int, D: int, itemsize: int, n_ep: int,
            cfg: ModelConfig, shards: int) -> None:
    """Two EP all-to-alls a layer call (dispatch and return trip), each
    moving the packed capacity buffer; ``B`` is the global batch over
    ``shards`` batch shards (the pods' data ranks).  The reference's
    bytes: its record takes ``C`` from the rows of a batch shard whatever
    the model axis does with S.  Nothing in a backward pass."""
    rec = obs.recorder()
    if rec.enabled and not _in_backward():
        a2a_bytes = float(n_ep * _capacity(B * S // shards, n_ep, cfg) * D
                          * itemsize)
        rec.record("all-to-all", a2a_bytes)
        rec.record("all-to-all", a2a_bytes)


def _capacity(T: int, n_ep: int, cfg: ModelConfig) -> int:
    K = cfg.moe_top_k
    return max(int(math.ceil(T * K / n_ep * cfg.capacity_factor)), K)


def _check_axes(mesh, ep_axis: str) -> None:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    others = {a: s for a, s in sizes.items()
              if a not in (ep_axis, "model", "pod") and s > 1}
    if others:
        raise NotImplementedError(
            f"the EP all-to-all runs over the data axis, within each pod, "
            f"and a model axis only, not {others}")


def _pods(mesh) -> int:
    """The mesh's pods (1 without a pod axis)."""
    return dict(zip(mesh.axis_names, mesh.shape)).get("pod", 1)


def _sharded(w: torch.Tensor, logical_dims: int) -> bool:
    """Model-axis storage ``[m, *local]`` of a leaf of ``logical_dims``."""
    return w.dim() == logical_dims + 1


def _for_columns(w: torch.Tensor, dim: Optional[int], logical_dims: int,
                 tp, cols: int) -> List[torch.Tensor]:
    """Each routing column's full copy of one weight: gathered over the
    model axis where it is stored sharded on local dimension ``dim``
    (every column its own copy, the gradients reduce-scattered), the
    replicated weight through the conjugate identity (its gradient
    all-reduced); with one column (no model axis, or S that does not
    split) the whole weight, computed once."""
    sharded = _sharded(w, logical_dims)
    if cols == 1:
        if sharded:
            return [torch.cat(list(tp.gather(w).unbind(0)), dim=dim)]
        return [w]
    each = tp.gather_each(w, dim) if sharded else tp.scatter(w)
    return list(each.unbind(0))


def _own_experts(w: torch.Tensor, q: int, E_loc: int, E: int) -> torch.Tensor:
    """EP rank ``q``'s experts of an expert leaf that holds all ``E`` of
    them (logical ``[E, ...]`` or model-axis storage ``[m, E, ...]``), or
    the leaf itself where it holds that rank's ``E_loc`` only."""
    dim = 1 if _sharded(w, 3) else 0
    if w.shape[dim] == E:
        return w.narrow(dim, q * E_loc, E_loc)
    if w.shape[dim] != E_loc:
        raise ValueError(f"an expert leaf of {w.shape[dim]} experts: want "
                         f"all {E} or a rank's {E_loc}")
    return w


def whole_weights(p, tp) -> Dict[str, Any]:
    """One MoE layer's tree with every model-sharded leaf gathered whole
    (held once): the dense dispatch's weights on a model axis."""
    out = {"router": p["router"]}
    for k, dim in _EXPERT_DIM.items():
        out[k] = _for_columns(p[k], dim, 3, tp, 1)[0]
    if "shared" in p:
        out["shared"] = {k: _for_columns(p["shared"][k], dim, 2, tp, 1)[0]
                         for k, dim in _SHARED_DIM.items()}
    return out


def moe_ranks(ps: Sequence[Dict[str, Any]], xs: Sequence[torch.Tensor],
              cfg: ModelConfig, tp=None, global_batch: Optional[int] = None
              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The armed EP layer over the data-parallel ranks of the virtual
    mesh: rank ``r``'s rows ``xs[r] [B_l, S, D]`` (replicated over the
    model axis when ``tp``, a
    :class:`~repro_torch.parallel.tensor.TensorParallel`, is given) and
    its view ``ps[r]`` of the layer's parameters (model-axis storage under
    ``tp``).  On a pod mesh the ``P * D`` ranks are pod-major, rank ``p *
    D + j`` being data rank ``j`` of pod ``p``, and each pod runs its own
    all-to-all over its ``D`` data ranks (:func:`_moe_pod`).  Data rank
    ``j`` uses its own router and shared experts and its ``E/D`` experts
    of ``ps[r]``'s (an expert leaf of ``ps[r]`` holds all ``E`` experts,
    or data rank ``j``'s alone).  Returns each rank's output and the aux
    loss (the mean over every routed shard of every pod).
    ``global_batch`` (the rows of all ranks, by default) sizes the obs
    records."""
    mesh, ep_axis = _EP_STATE["mesh"], _EP_STATE["ep"]
    order = _EP_STATE["a2a_order"]
    _check_axes(mesh, ep_axis)
    n, pods = mesh.axis_size(ep_axis), _pods(mesh)
    if len(xs) != pods * n or len(ps) != pods * n:
        raise ValueError(f"{len(xs)} shards for {pods} pods x {n} EP ranks")
    m = tp.m if tp is not None else 1
    if m != dict(zip(mesh.axis_names, mesh.shape)).get("model", 1):
        raise ValueError(f"a model axis of {m} under the armed mesh's "
                         f"{dict(zip(mesh.axis_names, mesh.shape))}")
    ys, aux = [], []
    for g in range(pods):
        got, got_aux = _moe_pod(ps[g * n:(g + 1) * n], xs[g * n:(g + 1) * n],
                                cfg, tp, order, pods)
        ys.extend(got)
        aux.extend(got_aux)
    Bl, S, D = xs[0].shape
    _record(global_batch or Bl * n * pods, S, D, xs[0].element_size(), n, cfg,
            n * pods)
    return ys, torch.stack(aux).mean()


def _moe_pod(ps: Sequence[Dict[str, Any]], xs: Sequence[torch.Tensor],
             cfg: ModelConfig, tp, order, pods: int
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One pod's EP layer over its ``n`` data ranks (:func:`moe_ranks`):
    each rank's output and every routed shard's aux loss.  ``pods``: the
    pods whose all-to-alls run one after another, of which a rank takes
    part in one."""
    n = len(xs)
    m = tp.m if tp is not None else 1
    E_loc = cfg.n_experts // n
    Bl, S, D = xs[0].shape
    cols = m if m > 1 and S % m == 0 else 1
    C = _capacity(Bl * (S // cols), n, cfg)

    # -- routing and packing, rank by rank and column by column ---------
    xcol = [tp.split(x, 1) if cols > 1 else x.unsqueeze(0) for x in xs]
    routed, send_x, send_e, aux = [], [], [], []
    for r in range(n):
        routers = _for_columns(ps[r]["router"], None, 2, tp, cols)
        per = [_route({"router": routers[j]}, xcol[r][j], cfg, n, C)
               for j in range(cols)]
        # [n_dst, cols, C, ...]: the columns' pieces to each destination
        send_x.append(torch.stack([t[0].reshape(n, C, D) for t in per], 1))
        send_e.append(torch.stack([t[1].reshape(n, C) for t in per], 1))
        routed.append([t[2] for t in per])
        aux.extend(t[3] for t in per)

    # -- the dispatch all-to-all over the data axis, every column --------
    recv_x = _a2a_shift(torch.stack(send_x), n, order, cols, pods)
    recv_e = _a2a_shift(torch.stack(send_e), n, order, cols, pods)

    # -- each rank's experts, at full d_ff, on what each column received -
    backs = []
    for q in range(n):
        w = {k: _for_columns(_own_experts(ps[q][k], q, E_loc, cfg.n_experts),
                             dim, 3, tp, cols)
             for k, dim in _EXPERT_DIM.items()}
        backs.append(torch.stack([
            _expert_pass({k: w[k][j] for k in w},
                         recv_x[q][:, j].reshape(n * C, D),
                         recv_e[q][:, j].reshape(n * C), cfg,
                         E_loc).reshape(n, C, D)
            for j in range(cols)], 1))

    # -- the return trip and the combine ---------------------------------
    ret = _a2a_shift(torch.stack(backs), n, order, cols, pods)
    ys = []
    for r in range(n):
        shared = None
        if "shared" in ps[r]:
            sw = {k: _for_columns(ps[r]["shared"][k], dim, 2, tp, cols)
                  for k, dim in _SHARED_DIM.items()}
            shared = [{k: sw[k][j] for k in sw} for j in range(cols)]
        outs = [_combine({} if shared is None else {"shared": shared[j]},
                         ret[r][:, j].reshape(n * C, D), routed[r][j],
                         xcol[r][j].shape) for j in range(cols)]
        if cols > 1:
            # the columns' rows back together along S, replicated
            y = tp.gather(torch.stack(outs)).movedim(0, 1).reshape(Bl, S, D)
        else:
            y = outs[0]
        ys.append(y)
    return ys, aux


def moe_a2a(p, x: torch.Tensor, cfg: ModelConfig, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for ``layers.moe_dense`` under an armed EP mesh
    (``moe_a2a.py:184-328``): the global batch ``x``, split over the data
    ranks (or, a batch that does not split, every rank routing all of it,
    as the reference replicates it), and one parameter tree (model-axis
    storage under ``tp``) — :func:`moe_ranks` with every rank on the same
    tree.  On a group-backed mesh, ``x`` is this process's batch block
    (see :func:`ep_rank`) and the result is its block's."""
    mesh, ep_axis = _EP_STATE["mesh"], _EP_STATE["ep"]
    _check_axes(mesh, ep_axis)
    if mesh.group is not None:
        if _pods(mesh) > 1:
            raise NotImplementedError(
                "EP over a process group runs one data axis, not a pod axis")
        return _moe_a2a_group(p, x, cfg, mesh, _EP_STATE["a2a_order"])
    n = mesh.axis_size(ep_axis) * _pods(mesh)
    split = x.shape[0] % n == 0
    shards = list(x.chunk(n)) if split else [x] * n
    ys, aux = moe_ranks([p] * n, shards, cfg, tp, x.shape[0])
    return (torch.cat(ys) if split else ys[0]), aux


def ep_rank(mesh=None) -> int:
    """The EP rank of this process under the EP mesh armed over a process
    group: the logical rank its mesh slot holds in the armed all-to-all's
    schedule.  It routes batch block ``ep_rank`` and holds experts
    ``ep_rank * E/n_ep`` to ``(ep_rank + 1) * E/n_ep``, as virtual rank
    ``ep_rank`` does."""
    from repro_torch.kernels.group_runner import local_rank

    mesh = mesh or _EP_STATE["mesh"]
    if mesh is None or mesh.group is None:
        raise ValueError("no EP mesh over a process group is armed")
    low = _lowered_a2a(mesh.size, _EP_STATE["a2a_order"])
    return local_rank(low.schedule, mesh)


def _a2a_group(buf: torch.Tensor, low, mesh, me: int) -> torch.Tensor:
    """The all-to-all over the group: this process's ``[n, ...]`` pieces
    (piece ``j`` addressed to EP rank ``j``) to the ``[n, ...]`` pieces it
    received (piece ``s`` from EP rank ``s``); the certified schedule of
    :func:`_lowered_a2a` through
    :func:`~repro_torch.kernels.group_runner.run_schedule_group`."""
    from repro_torch.kernels.group_runner import run_schedule_group

    n = buf.shape[0]
    row = run_schedule_group(buf.reshape(-1), low, mesh)
    # chunk s * n + d: the piece s sent to d
    return row[torch.arange(n, device=buf.device) * n + me].reshape(buf.shape)


class _GroupA2A(torch.autograd.Function):
    """The all-to-all over the group; backward, the same schedule on the
    cotangent: the gradient of the piece received from ``s`` goes back to
    ``s``, and arrives as the gradient of the piece it addressed here."""

    @staticmethod
    def forward(ctx, buf, low, mesh, me):
        ctx.args = (low, mesh, me)
        return _a2a_group(buf, low, mesh, me)

    @staticmethod
    def backward(ctx, g):
        return _a2a_group(g.contiguous(), *ctx.args), None, None, None


def _moe_a2a_group(p, x: torch.Tensor, cfg: ModelConfig, mesh,
                   a2a_order) -> Tuple[torch.Tensor, torch.Tensor]:
    """This process's EP rank of :func:`moe_a2a`: the same per-shard steps
    as the virtual mesh's rank, with both all-to-alls over the group, each
    differentiable (:class:`_GroupA2A`).  Every process must run the
    backward too: its all-to-alls are collectives."""
    import torch.distributed as dist

    n_ep = mesh.size
    E = cfg.n_experts
    E_loc = E // n_ep
    me = ep_rank(mesh)
    low = _lowered_a2a(n_ep, None if a2a_order is None else tuple(a2a_order))
    Bl, S, D = x.shape
    C = _capacity(Bl * S, n_ep, cfg)
    send_x, send_e, routed, aux = _route(p, x, cfg, n_ep, C)
    recv_x = _GroupA2A.apply(send_x.reshape(n_ep, C, D), low, mesh, me)
    recv_e = _a2a_group(send_e.reshape(n_ep, C), low, mesh, me)
    held = p["w1"].shape[0]
    if held not in (E, E_loc):
        raise ValueError(f"the experts' leading dimension is {held}: want "
                         f"all {E} or this rank's {E_loc}")
    mine = slice(me * E_loc, (me + 1) * E_loc) if held == E else slice(None)
    back = _expert_pass({k: p[k][mine] for k in ("w1", "w3", "w2")},
                        recv_x.reshape(n_ep * C, D),
                        recv_e.reshape(n_ep * C), cfg, E_loc)
    ret = _GroupA2A.apply(back.reshape(n_ep, C, D), low, mesh, me)
    y = _combine(p, ret.reshape(n_ep * C, D), routed, x.shape)
    # the reference's pmean of the aux loss: every rank's, stacked in EP
    # rank order and averaged as the virtual mesh averages them; this
    # rank's own term carries its gradient
    got = [None] * n_ep
    dist.all_gather_object(got, (me, aux.item()), group=mesh.group)
    by_rank = dict(got)
    aux_all = torch.stack([aux if r == me else aux.new_tensor(by_rank[r])
                           for r in range(n_ep)])
    _record(Bl * n_ep, S, D, x.element_size(), n_ep, cfg, n_ep)
    return y, aux_all.mean()
