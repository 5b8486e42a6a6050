"""The baseline train step: loss -> grads -> AdamW (port of ``repro.train.train_step``).

:func:`make_train_step` is one card, no sharding: the step computes the
loss and its gradient over the whole batch with ``torch.autograd`` and
applies AdamW.  It is the yardstick the overlapped data-parallel step
(:mod:`repro_torch.train.overlap_grads`) and the sharded step are held
to.  The sharding half: :func:`state_pspecs` (tensor-parallel parameters,
ZeRO-1 moments), :func:`batch_pspecs`, and :func:`jit_train_step` with
the reference's signature, which returns the tensor-parallel ZeRO-1 step
(:mod:`repro_torch.train.sharded_step`) or, for an overlap mode, the
overlapped data-parallel step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.optim import AdamWConfig, OptState, apply_opt, init_opt
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["TrainState", "batch_pspecs", "init_state", "jit_train_step",
           "make_train_step", "state_pspecs", "value_and_grad"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    step: torch.Tensor


def init_state(model, generator: torch.Generator) -> TrainState:
    """Parameters drawn from ``generator``, zero AdamW moments, step 0."""
    params = model.init(generator)
    return TrainState(params=params, opt=init_opt(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=generator.device))


def batch_on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as int64 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v
                               ).to(device=device, dtype=torch.long)
            for k, v in batch.items()}


def value_and_grad(model, params: Any, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Any]:
    """``(loss, grads)`` of ``model.loss`` at ``params``; grads as a tree."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = model.loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(
    model, opt_cfg: AdamWConfig
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """The baseline step: full-batch loss and grads, one AdamW update."""
    def train_step(state: TrainState, batch: Dict[str, Any]):
        batch = batch_on(batch, model.device)
        loss, grads = value_and_grad(model, state.params, batch)
        new_params, new_opt, metrics = apply_opt(
            opt_cfg, state.params, grads, state.opt)
        metrics = dict(metrics, loss=loss)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def state_pspecs(state_shapes: TrainState, cfg, mesh) -> TrainState:
    """PartitionSpecs for a TrainState: TP params + ZeRO-1 moments."""
    from repro_torch.parallel import sharding as shd

    pspecs = shd.param_pspecs(state_shapes.params, cfg, mesh)
    m_specs = tree_unflatten(pspecs, [
        shd.zero1_spec(s, tuple(leaf.shape), mesh)
        for s, leaf in zip(tree_leaves(pspecs),
                           tree_leaves(state_shapes.params))])
    return TrainState(params=pspecs,
                      opt=OptState(m=m_specs, v=m_specs, count=shd.P()),
                      step=shd.P())


def batch_pspecs(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Each batch leaf split over the dp axes on its first dimension."""
    from repro_torch.parallel import sharding as shd

    bs = shd.batch_spec(mesh)
    return {k: shd.P(*bs, *([None] * (len(v.shape) - 1)))
            for k, v in batch.items()}


def jit_train_step(model, opt_cfg, cfg, mesh, state_shapes=None,
                   batch_shapes=None, donate: bool = True,
                   overlap: str = "off", reducer: Any = None,
                   axis: str = "data"):
    """The reference's ``jit_train_step`` signature.

    ``overlap="off"``: the tensor-parallel, ZeRO-1 step on ``mesh``
    (:func:`~repro_torch.train.sharded_step.make_sharded_train_step`;
    ``reducer`` is the data axis's all-reduce when it has more than one
    rank); ``state_shapes``, ``batch_shapes`` and ``donate`` have nothing
    to do here (the step reads the specs from the model, and makes new
    tensors).  ``"bucketed"``/``"fused"``: the overlapped data-parallel
    step over ``reducer``, in that mode, as the reference delegates.
    ``cfg`` and ``axis`` are the reference's; the model carries its
    config, and the virtual mesh's data axis is the reducer's.
    """
    if overlap != "off":
        from .overlap_grads import (
            OVERLAP_MODES, OverlapGradReducer, make_overlap_train_step)

        if overlap not in OVERLAP_MODES:
            raise ValueError(f"overlap must be 'off' or one of "
                             f"{OVERLAP_MODES}, got {overlap!r}")
        if reducer is None:
            raise ValueError("overlap != 'off' needs a reducer "
                             "(Session.overlap_step or "
                             "overlap_grads.reducer_from_plan)")
        if reducer.mode != overlap:
            reducer = OverlapGradReducer(
                reducer.schedule, bucket_bytes=reducer.bucket_bytes,
                mode=overlap, use_kernel_add=reducer.use_kernel_add,
                transport=reducer.transport)
        return make_overlap_train_step(model, opt_cfg, reducer)
    from .sharded_step import make_sharded_train_step

    return make_sharded_train_step(model, opt_cfg, mesh, reducer)
