"""Expert-parallel MoE over an explicit all-to-all (counterpart of
``repro.parallel.moe_a2a``).

The reference's weight-gathered EP design, on the port's virtual mesh:

1. the tokens stay where they are: the batch is split over the ``n_ep``
   EP ranks, which are the leading dimension of the token shards (shard
   ``i`` is batch block ``i``, mesh slot ``i``); routing is local to a
   shard;
2. each (token, k) choice is packed into a capacity-bounded ``[n_ep, C,
   D]`` buffer, which the EP all-to-all delivers: a certified
   ``all_to_all`` schedule (:func:`_lowered_a2a`) whose rounds walk the
   plan's solved shift ring (:func:`arm_ep`), executed by
   :func:`repro_torch.kernels.schedule_runner.run_schedule` as index
   gathers — the communication pattern the paper's ``AllToAllCost``
   prices;
3. every received token runs its expert's whole FFN on the rank that
   holds the expert (``E / n_ep`` experts a rank).  The virtual mesh has
   no model axis, so the weights are whole: the reference's
   ``tp_axis=None`` case, where its weight gather is the identity;
4. the results go back by a second all-to-all and are combined, weighted,
   at the source.

Gradients flow through the packing, the schedule's gathers and the
combine.  A mesh with a second axis of more than one slot is refused.

Over a mesh of processes (``make_planned_mesh(..., group=...)``) each
process is one EP rank (:func:`ep_rank`): it routes its batch block,
holds its ``E / n_ep`` experts (or all of them, and uses its own), and
both all-to-alls run the same certified schedule through
:func:`repro_torch.kernels.group_runner.run_schedule_group`, so its block
of the result is the virtual mesh's bit for bit.  That path runs forward
only: under grad it raises (MoE training over processes is ROADMAP.md §1
item 18).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import schedule_runner
from repro_torch.tree import tree_leaves

__all__ = ["arm_ep", "clear_ep", "ep_armed", "ep_rank", "moe_a2a"]

_EP_STATE: Dict[str, Any] = {"mesh": None, "ep": None, "a2a_order": None}


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
    the order.  ``tp_axis`` keeps the reference's signature: the virtual
    mesh has no model axis, and :func:`moe_a2a` refuses a mesh with a
    second axis of more than one slot.
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
    _EP_STATE.update(mesh=mesh, ep=ep, a2a_order=order)


def clear_ep() -> None:
    _EP_STATE.update(mesh=None, ep=None, a2a_order=None)


def ep_armed(cfg: ModelConfig) -> bool:
    """An EP mesh is armed and its degree divides the experts."""
    m = _EP_STATE["mesh"]
    if m is None or _EP_STATE["ep"] is None:
        return False
    return cfg.n_experts % m.axis_size(_EP_STATE["ep"]) == 0


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
               order: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The all-to-all over the virtual mesh: ``x [n, n, ...]`` — rank
    ``i``'s piece ``j`` is addressed to rank ``j`` — to ``[n, n, ...]``
    with rank ``d``'s piece ``s`` received from rank ``s``.

    The certified schedule of :func:`_lowered_a2a` runs through
    :func:`~repro_torch.kernels.schedule_runner.run_schedule` (its
    ``addressed`` init: a rank's row is its n outgoing pieces; a round is
    one index gather of the pieces in flight).
    """
    sched = _lowered_a2a(n, None if order is None else tuple(order)).schedule
    out = schedule_runner.run_schedule(x.reshape(n, -1), sched)
    # out[d, s * n + d]: the piece s sent to d
    pick = torch.arange(n, device=x.device)
    got = out.reshape(n, n, n, -1)[pick[:, None], pick[None, :], pick[:, None]]
    return got.reshape(x.shape)


def _route(p, xl: torch.Tensor, cfg: ModelConfig, n_ep: int, C: int):
    """One shard's routing and packing (``moe_a2a.py:227-262``): its
    ``[n_ep * C, D]`` send buffer, the local expert of every slot, what
    the combine needs, and the shard's aux loss."""
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
    send_e = torch.zeros(n_ep * C, dtype=torch.int64,
                         device=xl.device).index_add(
        0, slot, torch.where(keep, local_e[order], 0))
    slot_of = torch.full((T * K,), -1, dtype=torch.int64, device=xl.device)
    slot_of[order] = torch.where(keep, slot, -1)
    return send_x, send_e, (xf, w.reshape(-1).to(xl.dtype), slot_of), aux


def _expert_pass(w: Dict[str, torch.Tensor], rx: torch.Tensor,
                 re: torch.Tensor, cfg: ModelConfig, E_loc: int) -> torch.Tensor:
    """One rank's experts (``w``: their ``w1``/``w3``/``w2``) on the
    ``[T2, D]`` tokens it received, packed by expert with capacity, and
    the results back in arrival order (``moe_a2a.py:272-293``)."""
    from repro_torch.models.layers import _experts, _pack

    T2, D = rx.shape
    C2 = max(int(math.ceil(T2 / E_loc * cfg.capacity_factor)), 1)
    order2, keep2, slot2 = _pack(re, E_loc, C2)
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
            cfg: ModelConfig) -> None:
    """Two EP all-to-alls a layer call (dispatch and return trip), each
    moving the packed capacity buffer; ``B`` is the global batch."""
    rec = obs.recorder()
    if rec.enabled:
        a2a_bytes = float(n_ep * _capacity(B * S // n_ep, n_ep, cfg) * D
                          * itemsize)
        rec.record("all-to-all", a2a_bytes)
        rec.record("all-to-all", a2a_bytes)


def _capacity(T: int, n_ep: int, cfg: ModelConfig) -> int:
    K = cfg.moe_top_k
    return max(int(math.ceil(T * K / n_ep * cfg.capacity_factor)), K)


def moe_a2a(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for ``layers.moe_dense`` under an armed EP mesh
    (``moe_a2a.py:227-380``): the same routing, capacities and combine as
    the reference's shard-mapped body, shard by shard on the virtual mesh,
    with both all-to-alls through the certified schedule.  On a
    group-backed mesh, ``x`` is this process's batch block (see
    :func:`ep_rank`) and the result is its block's."""
    mesh, ep_axis = _EP_STATE["mesh"], _EP_STATE["ep"]
    a2a_order = _EP_STATE["a2a_order"]
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    others = {a: s for a, s in sizes.items() if a != ep_axis and s > 1}
    if others:
        raise NotImplementedError(
            f"the virtual mesh's EP all-to-all runs over one axis; {others} "
            f"(sharded weights or a second batch axis) wait for the sharding "
            f"specs, ROADMAP.md §1 item 11")
    if mesh.group is not None:
        return _moe_a2a_group(p, x, cfg, mesh, a2a_order)
    n_ep = sizes[ep_axis]
    E_loc = cfg.n_experts // n_ep
    B, S, D = x.shape
    # the batch split over the EP ranks, or (a batch that does not split)
    # every rank routing all of it, as the reference replicates it
    split = B % n_ep == 0
    shards = list(x.chunk(n_ep)) if split else [x] * n_ep
    C = _capacity(shards[0].shape[0] * S, n_ep, cfg)

    # -- routing and packing, shard by shard -----------------------------
    routed, send_x, send_e, aux = [], [], [], []
    for xl in shards:
        sx, se, rt, a = _route(p, xl, cfg, n_ep, C)
        send_x.append(sx)
        send_e.append(se)
        routed.append(rt)
        aux.append(a)

    # -- the dispatch all-to-all -----------------------------------------
    recv_x = _a2a_shift(torch.stack(send_x).reshape(n_ep, n_ep, C, D), n_ep,
                        a2a_order)
    recv_e = _a2a_shift(torch.stack(send_e).reshape(n_ep, n_ep, C), n_ep,
                        a2a_order)

    # -- each rank's experts on what it received -------------------------
    backs = []
    for r in range(n_ep):
        mine = slice(r * E_loc, (r + 1) * E_loc)
        backs.append(_expert_pass({k: p[k][mine] for k in ("w1", "w3", "w2")},
                                  recv_x[r].reshape(n_ep * C, D),
                                  recv_e[r].reshape(n_ep * C), cfg, E_loc))

    # -- the return trip and the combine ---------------------------------
    ret = _a2a_shift(torch.stack(backs).reshape(n_ep, n_ep, C, D), n_ep,
                     a2a_order)
    ys = [_combine(p, ret[r].reshape(n_ep * C, D), routed[r], xl.shape)
          for r, xl in enumerate(shards)]
    _record(B, S, D, x.element_size(), n_ep, cfg)
    y = torch.cat(ys) if split else ys[0]
    return y, torch.stack(aux).mean()


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


def _moe_a2a_group(p, x: torch.Tensor, cfg: ModelConfig, mesh,
                   a2a_order) -> Tuple[torch.Tensor, torch.Tensor]:
    """This process's EP rank of :func:`moe_a2a`: the same per-shard steps
    as the virtual mesh's rank, with both all-to-alls over the group.
    Forward only: the group runner moves tensors, not gradients."""
    import torch.distributed as dist

    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in tree_leaves(p))):
        raise NotImplementedError(
            "the EP all-to-all over a process group runs forward only; MoE "
            "training over processes is ROADMAP.md §1 item 18")
    n_ep = mesh.size
    E = cfg.n_experts
    E_loc = E // n_ep
    me = ep_rank(mesh)
    low = _lowered_a2a(n_ep, None if a2a_order is None else tuple(a2a_order))
    Bl, S, D = x.shape
    C = _capacity(Bl * S, n_ep, cfg)
    send_x, send_e, routed, aux = _route(p, x, cfg, n_ep, C)
    recv_x = _a2a_group(send_x.reshape(n_ep, C, D), low, mesh, me)
    recv_e = _a2a_group(send_e.reshape(n_ep, C), low, mesh, me)
    held = p["w1"].shape[0]
    if held not in (E, E_loc):
        raise ValueError(f"the experts' leading dimension is {held}: want "
                         f"all {E} or this rank's {E_loc}")
    mine = slice(me * E_loc, (me + 1) * E_loc) if held == E else slice(None)
    back = _expert_pass({k: p[k][mine] for k in ("w1", "w3", "w2")},
                        recv_x.reshape(n_ep * C, D),
                        recv_e.reshape(n_ep * C), cfg, E_loc)
    ret = _a2a_group(back.reshape(n_ep, C, D), low, mesh, me)
    y = _combine(p, ret.reshape(n_ep * C, D), routed, x.shape)
    # the reference's pmean of the aux loss: every rank's, stacked in EP
    # rank order and averaged as the virtual mesh averages them
    got = [None] * n_ep
    dist.all_gather_object(got, (me, aux.item()), group=mesh.group)
    by_rank = dict(got)
    aux_all = torch.tensor([by_rank[r] for r in range(n_ep)],
                           dtype=aux.dtype, device=aux.device)
    _record(Bl * n_ep, S, D, x.element_size(), n_ep, cfg)
    return y, aux_all.mean()

