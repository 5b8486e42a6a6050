"""The baseline train step: loss -> grads -> AdamW (port of ``repro.train.train_step``).

One card, no sharding: the step computes the loss and its gradient over
the whole batch with ``torch.autograd`` and applies AdamW.  It is the
yardstick the overlapped data-parallel step
(:mod:`repro_torch.train.overlap_grads`) is held to.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.optim import AdamWConfig, OptState, apply_opt, init_opt
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["TrainState", "init_state", "make_train_step", "value_and_grad"]


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
