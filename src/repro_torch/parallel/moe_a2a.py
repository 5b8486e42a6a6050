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
combine.  A mesh of processes (``make_planned_mesh(..., group=...)``) and
a mesh with a second axis of more than one slot are refused.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import schedule_runner

__all__ = ["arm_ep", "clear_ep", "ep_armed", "moe_a2a"]

_EP_STATE: Dict[str, Any] = {"mesh": None, "ep": None, "a2a_order": None}


def arm_ep(mesh, ep_axis: str = "data", tp_axis: Optional[str] = "model",
           plan=None, session=None) -> None:
    """Arm expert parallelism over ``mesh`` (a virtual
    :class:`~repro_torch.launch.mesh.PlannedMesh`); ``plan`` (a
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
    if mesh.group is not None:
        raise NotImplementedError(
            "the EP all-to-all runs on the virtual mesh only; over a process "
            "group it is queued in ROADMAP.md §1 item 19")
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


def moe_a2a(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for ``layers.moe_dense`` under an armed EP mesh
    (``moe_a2a.py:227-380``): the same routing, capacities and combine as
    the reference's shard-mapped body, shard by shard on the virtual mesh,
    with both all-to-alls through the certified schedule."""
    from repro_torch.models.layers import _experts, _pack, _router_probs, mlp

    mesh, ep_axis = _EP_STATE["mesh"], _EP_STATE["ep"]
    a2a_order = _EP_STATE["a2a_order"]
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    others = {a: s for a, s in sizes.items() if a != ep_axis and s > 1}
    if others:
        raise NotImplementedError(
            f"the virtual mesh's EP all-to-all runs over one axis; {others} "
            f"(sharded weights or a second batch axis) wait for the sharding "
            f"specs, ROADMAP.md §1 item 11")
    n_ep = sizes[ep_axis]
    E, K = cfg.n_experts, cfg.moe_top_k
    E_loc = E // n_ep
    B, S, D = x.shape
    # the batch split over the EP ranks, or (a batch that does not split)
    # every rank routing all of it, as the reference replicates it
    split = B % n_ep == 0
    shards = list(x.chunk(n_ep)) if split else [x] * n_ep
    Bl = shards[0].shape[0]
    T = Bl * S
    TK = T * K
    C = max(int(math.ceil(T * K / n_ep * cfg.capacity_factor)), K)

    # -- routing and packing, shard by shard -----------------------------
    routed, send_x, send_e, aux = [], [], [], []
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    for xl in shards:
        xf = xl.reshape(T, D)
        idx, w, shard_aux = _router_probs(p, xf, cfg)
        aux.append(shard_aux)
        dest = (idx // E_loc).reshape(-1)
        local_e = (idx % E_loc).reshape(-1)
        order, keep, slot = _pack(dest, n_ep, C)
        send_x.append(xf.new_zeros((n_ep * C, D)).index_add(
            0, slot, torch.where(keep[:, None], xf[tok[order]], 0)))
        send_e.append(torch.zeros(n_ep * C, dtype=torch.int64,
                                  device=x.device).index_add(
            0, slot, torch.where(keep, local_e[order], 0)))
        slot_of = torch.full((TK,), -1, dtype=torch.int64, device=x.device)
        slot_of[order] = torch.where(keep, slot, -1)
        routed.append((xf, w.reshape(-1).to(x.dtype), slot_of))

    # -- the dispatch all-to-all -----------------------------------------
    recv_x = _a2a_shift(torch.stack(send_x).reshape(n_ep, n_ep, C, D), n_ep,
                        a2a_order)
    recv_e = _a2a_shift(torch.stack(send_e).reshape(n_ep, n_ep, C), n_ep,
                        a2a_order)

    # -- each rank's experts on what it received -------------------------
    T2 = n_ep * C
    C2 = max(int(math.ceil(T2 / E_loc * cfg.capacity_factor)), 1)
    backs = []
    for r in range(n_ep):
        rx, re = recv_x[r].reshape(T2, D), recv_e[r].reshape(T2)
        order2, keep2, slot2 = _pack(re, E_loc, C2)
        xin = rx.new_zeros((E_loc * C2, D)).index_add(
            0, slot2, torch.where(keep2[:, None], rx[order2], 0))
        mine = slice(r * E_loc, (r + 1) * E_loc)
        xout = _experts({k: p[k][mine] for k in ("w1", "w3", "w2")},
                        xin.reshape(E_loc, C2, D), "").reshape(-1, D)
        backs.append(rx.new_zeros((T2, D)).index_add(
            0, order2, torch.where(keep2[:, None], xout[slot2], 0)))

    # -- the return trip and the combine ---------------------------------
    ret = _a2a_shift(torch.stack(backs).reshape(n_ep, n_ep, C, D), n_ep,
                     a2a_order)
    ys = []
    for r, (xf, wk, slot_of) in enumerate(routed):
        got = ret[r].reshape(T2, D)
        contrib = torch.where((slot_of >= 0)[:, None],
                              got[slot_of.clamp_min(0)], 0)
        y = xf.new_zeros((T, D)).index_add(0, tok, contrib * wk[:, None])
        if "shared" in p:
            y = y + mlp(p["shared"], xf)
        ys.append(y.reshape(Bl, S, D))

    # two EP all-to-alls a layer call (dispatch and return trip), each
    # moving the packed capacity buffer
    rec = obs.recorder()
    if rec.enabled:
        c = max(int(math.ceil(B * S // n_ep * K / n_ep
                              * cfg.capacity_factor)), K)
        a2a_bytes = float(n_ep * c * D * x.element_size())
        rec.record("all-to-all", a2a_bytes)
        rec.record("all-to-all", a2a_bytes)
    y = torch.cat(ys) if split else ys[0]
    return y, torch.stack(aux).mean()
