"""AdamW with global-norm clipping (counterpart of ``repro.optim.adamw``).

The state mirrors the parameter tree (``m``, ``v`` in f32, plus a scalar
step count), and the update is the reference's arithmetic: f32 moments,
the step computed in f32 and cast back to each parameter's dtype.  The
update is functional, as in the reference: it returns new tensors and
leaves its inputs as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "OptState", "init_opt", "apply_opt", "adamw_update",
           "global_norm", "cosine_schedule"]


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor          # int32 scalar, on the parameters' device


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak``, then cosine decay to ``floor * peak``."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return fn


def init_opt(params: Any) -> OptState:
    """Zero moments in f32, one per parameter; the count at 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, p: torch.Tensor, g: torch.Tensor,
                 m: torch.Tensor, v: torch.Tensor, scale, lr, b1c, b2c
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tensor's AdamW step (``(p', m', v')``): the clip's ``scale``,
    f32 moments, the step in f32 cast back to ``p``'s dtype.  Elementwise,
    so a slice of a parameter (ZeRO-1's) updates as the whole would."""
    g = g.float() * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mh = m / b1c
    vh = v / b2c
    step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
    return (p.float() - lr * step).to(p.dtype), m, v


@torch.no_grad()
def apply_opt(
    cfg: AdamWConfig, params: Any, grads: Any, state: OptState
) -> Tuple[Any, OptState, dict]:
    """One AdamW step.  Returns (params', state', metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    lr = cfg.schedule(count) if cfg.schedule is not None else cfg.lr
    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)

    out = [adamw_update(cfg, p, g, m, v, scale, lr, b1c, b2c)
           for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32,
                                     device=gnorm.device)}
    return new_p, OptState(new_m, new_v, count), metrics
