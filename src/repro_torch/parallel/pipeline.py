"""Pipeline parallelism: GPipe microbatching over a stage axis (counterpart
of ``repro.parallel.pipeline``).

The reference runs a ``shard_map`` over the ``stage`` axis: stage ``i``
holds the stacked parameters of its slice of layers, and a ``lax.scan``
of ``n_micro + n_stages - 1`` ticks moves the activations one stage along
the ring ``i -> i + 1 (mod n)`` with ``ppermute``; stage 0 is fed
microbatch ``t`` at tick ``t < n_micro``, the last stage records
microbatch ``t - (n_stages - 1)``, and a ``psum`` over a one-hot mask
broadcasts the last stage's outputs to every stage.  Backward is the
scan's and the ppermute's transpose.

The port runs the same schedule on the port's two meshes
(:mod:`repro_torch.launch.mesh`):

* **the virtual mesh** — the stages are the leading dimension of the
  parameter leaves; each tick runs every stage that holds a microbatch,
  one after the other in Python (``stage_fn`` may launch the flash
  kernel, which ``torch.func.vmap`` cannot trace), and the ppermute is an
  index gather of the stages' outputs in axis-index order.  Backward is
  plain autograd;
* **a group-backed mesh** (``make_planned_mesh(plan, device,
  group=...)``) — stage ``i`` runs in the process at group rank
  ``mesh.order[i]``, as the group runner places schedule positions.  The
  hop to the next stage is a send/recv pair over gloo, staged through
  pinned host memory for a row on the card; as a
  :class:`torch.autograd.Function` its backward sends the cotangent to
  the previous stage (the ppermute's transpose).  The last stage's
  outputs are broadcast from its process.

A tick in which a stage holds no microbatch (the fill and drain bubbles)
is skipped: the reference computes it and masks its result, so the
outputs and gradients are the same.  With the bubbles skipped the ring's
hop ``n - 1 -> 0`` carries no live microbatch, and over a group it is not
sent.

**Whose loss counts over a group.**  The reference's caller takes stage
0's copy of the broadcast outputs (``out[0]``), so the gradient is that
of one loss.  Every process calls ``backward`` on its own loss (each one
runs its stage's part of the backward pass), but only the cotangent of
the process holding stage 0 travels back to the last stage; the other
processes' losses contribute nothing.  So the stages' gradients are the
virtual mesh's, not ``n_stages`` times them.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["pipeline_forward", "pipeline_loss"]


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x: torch.Tensor, mesh,
                     axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn`` as an ``n_stages``-deep pipeline over microbatches.

    ``stage_params``: a tree whose leaves are ``[n_stages, ...]``; ``x``:
    ``[n_micro, mb, ...]`` on the mesh's device type.  ``stage_fn(params,
    h)`` maps a microbatch to one of the same shape and dtype (the wire
    register).  Returns ``[n_micro, mb, ...]``: every microbatch after all
    stages, on every process of a group-backed mesh.
    """
    n_stages = mesh.axis_size(axis)
    if x.device.type != torch.device(mesh.device).type:
        raise ValueError(f"the microbatches are on {x.device}, the mesh's "
                         f"stages on {mesh.device}")
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(f"a stage-parameter leaf of shape "
                             f"{tuple(leaf.shape)}: want [n_stages="
                             f"{n_stages}, ...]")
    if mesh.group is None:
        return _virtual(stage_fn, stage_params, x, n_stages)
    return _grouped(stage_fn, stage_params, x, mesh)


def pipeline_loss(stage_fn: Callable, head_fn: Callable[[torch.Tensor,
                                                         torch.Tensor],
                                                        torch.Tensor],
                  stage_params: Any, x: torch.Tensor, labels: torch.Tensor,
                  mesh, axis: str = "stage") -> torch.Tensor:
    """Mean loss over microbatches through the pipeline."""
    return head_fn(pipeline_forward(stage_fn, stage_params, x, mesh, axis),
                   labels)


def _wire(out: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    if out.shape != h.shape or out.dtype != h.dtype:
        raise ValueError(f"stage_fn maps {tuple(h.shape)} {h.dtype} to "
                         f"{tuple(out.shape)} {out.dtype}; the wire register "
                         f"wants the microbatch's shape and dtype")
    return out


def _virtual(stage_fn, stage_params, x, n: int) -> torch.Tensor:
    """The tick schedule on one device, the stages in a Python loop."""
    n_micro = x.shape[0]
    params = [tree_map(lambda a, i=i: a[i], stage_params) for i in range(n)]
    # ppermute over fwd_perm (i, i + 1 mod n): stage d receives from d - 1
    src = [(d - 1) % n for d in range(n)]
    wire: List[Any] = [None] * n
    outs: List[Any] = [None] * n_micro
    for t in range(n_micro + n - 1):
        new: List[Any] = [None] * n
        for i in range(n):
            m = t - i
            if not 0 <= m < n_micro:          # a bubble: masked in the reference
                continue
            h = x[m] if i == 0 else wire[i]
            new[i] = _wire(stage_fn(params[i], h), h)
        if t >= n - 1:
            outs[t - (n - 1)] = new[n - 1]
        wire = [new[s] for s in src]
    return torch.stack(outs)


class _Link:
    """This process's place in the stage chain of a group-backed mesh."""

    def __init__(self, mesh, x: torch.Tensor):
        from repro_torch.kernels.group_runner import _Stager

        if len(mesh.shape) != 1:
            raise ValueError(f"a group-backed pipeline runs over one axis, "
                             f"not the mesh shape {mesh.shape}")
        backend = dist.get_backend(mesh.group)
        if backend != "gloo":
            raise ValueError(f"the pipeline's hops move over gloo, not "
                             f"{backend!r}")
        self.group = mesh.group
        self.n = mesh.size
        self.stage = mesh.slot
        self.n_micro = x.shape[0]
        self.mb_shape = tuple(x.shape[1:])
        self.dtype = x.dtype
        # stage i lives in the process at group rank order[i]
        self.peer = [dist.get_global_rank(self.group, g) for g in mesh.order]
        self.stager = _Stager(x.device)
        self.pending: list = []

    # tags: the forward hop of microbatch m, its cotangent, the output's
    def fwd_tag(self, m: int) -> int:
        return m

    def bwd_tag(self, m: int) -> int:
        return self.n_micro + m

    @property
    def out_tag(self) -> int:
        return 2 * self.n_micro

    def isend(self, t: torch.Tensor, stage: int, tag: int) -> None:
        """Post a send of ``t`` to ``stage``'s process; the host copy is
        kept until :meth:`flush` waits on it."""
        host = self.stager.out(t.detach().contiguous())
        work = dist.isend(host, self.peer[stage], self.group, tag)
        self.pending.append((work, host))

    def recv(self, shape, stage: int, tag: int) -> torch.Tensor:
        host = self.stager.buffer(shape, self.dtype)
        dist.recv(host, self.peer[stage], self.group, tag)
        return self.stager.into(host)

    def flush(self) -> None:
        for work, _host in self.pending:
            work.wait()
        self.pending.clear()

    def flush_after_backward(self) -> None:
        """Wait on the sends posted in a backward pass once it ends."""
        torch.autograd.Variable._execution_engine.queue_callback(self.flush)


class _Hop(torch.autograd.Function):
    """The ppermute out of this stage: sends microbatch ``m``'s output to
    the next stage and returns an empty token that ties the send into the
    graph; backward receives the output's cotangent from the next stage."""

    @staticmethod
    def forward(ctx, out, link, m):
        link.isend(out, link.stage + 1, link.fwd_tag(m))
        ctx.link, ctx.m = link, m
        return out.new_empty(0)

    @staticmethod
    def backward(ctx, _token):
        link = ctx.link
        g = link.recv(link.mb_shape, link.stage + 1, link.bwd_tag(ctx.m))
        return g, None, None


class _Land(torch.autograd.Function):
    """The ppermute into this stage: receives microbatch ``m`` from the
    previous stage; backward sends its cotangent back there."""

    @staticmethod
    def forward(ctx, anchor, link, m):
        ctx.link, ctx.m = link, m
        return link.recv(link.mb_shape, link.stage - 1, link.fwd_tag(m))

    @staticmethod
    def backward(ctx, g):
        link = ctx.link
        link.isend(g, link.stage - 1, link.bwd_tag(ctx.m))
        link.flush_after_backward()
        return g.new_zeros(0), None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs on every process (the reference's masked
    ``psum``).  Backward: the process holding stage 0 sends its cotangent
    to the last stage's process, which takes it as its outputs' gradient;
    every other process's cotangent is dropped (the reference's
    ``out[0]``).  The tokens carry no gradient: they only reach each
    stage's :class:`_Hop` in the backward pass."""

    @staticmethod
    def forward(ctx, outs, link, *tokens):
        ctx.link, ctx.n_tokens = link, len(tokens)
        last = link.n - 1
        shape = (link.n_micro,) + link.mb_shape
        if link.stage == last:
            host = link.stager.out(outs.detach().contiguous())
        else:
            host = link.stager.buffer(shape, link.dtype)
        dist.broadcast(host, link.peer[last], link.group)
        return outs.clone() if link.stage == last else link.stager.into(host)

    @staticmethod
    def backward(ctx, g):
        link = ctx.link
        last = link.n - 1
        g_outs = None
        if link.stage == last:
            g_outs = g if link.stage == 0 else link.recv(
                (link.n_micro,) + link.mb_shape, 0, link.out_tag)
        elif link.stage == 0:
            link.isend(g, last, link.out_tag)
            link.flush_after_backward()
        return (g_outs, None) + tuple(g.new_zeros(0)
                                      for _ in range(ctx.n_tokens))


def _grouped(stage_fn, stage_params, x, mesh) -> torch.Tensor:
    """This process's stage of the tick schedule, bubbles skipped: at tick
    ``t = m + stage`` it runs microbatch ``m``."""
    link = _Link(mesh, x)
    s, n = link.stage, link.n
    params = tree_map(lambda a: a[s], stage_params)
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad
                               for t in tree_leaves(stage_params)))
    anchor = x.new_empty(0, requires_grad=needs_grad)
    outs, tokens = [], []
    for m in range(link.n_micro):
        h = x[m] if s == 0 else _Land.apply(anchor, link, m)
        out = _wire(stage_fn(params, h), h)
        if s == n - 1:
            outs.append(out)
        else:
            tokens.append(_Hop.apply(out, link, m))
    link.flush()
    mine = torch.stack(outs) if s == n - 1 else x.new_empty(0)
    return _Broadcast.apply(mine, link, *tokens)
