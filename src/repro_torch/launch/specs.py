"""Sharded input stand-ins for every (arch x shape) cell (counterpart of
``repro.launch.specs``).

:func:`input_specs` builds, for each input of a cell's step function, a
meta-device tensor with the reference's shape and dtype paired with its
partition spec (:class:`MetaSpec`): nothing is allocated, so the
236B-parameter cells build on any host.  :func:`configure_sp` arms the
sequence-parallel and expert-parallel contexts as the reference's
launchers do, and :func:`step_callable` is the function each cell runs
unsharded.  The dry run (:mod:`repro_torch.launch.dryrun`, ROADMAP.md §1
item 15b) counts each cell through the step the port's command runs on
the mesh instead, and reads these stand-ins for its serving cells.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig, ShapeSpec
from repro_torch.models import get_model
from repro_torch.optim import OptState
from repro_torch.parallel import sharding as shd
from repro_torch.train.train_step import TrainState, state_pspecs
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["MetaSpec", "configure_sp", "input_specs", "step_callable"]


@dataclasses.dataclass(frozen=True)
class MetaSpec:
    """One input's stand-in: a meta tensor (shape and dtype) and its
    partition spec on ``mesh`` (the reference's sharded
    ``ShapeDtypeStruct``)."""

    tensor: torch.Tensor
    spec: shd.P
    mesh: Any

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _with_sharding(shapes: Any, pspecs: Any, mesh) -> Any:
    return tree_unflatten(shapes, [
        MetaSpec(t, s, mesh)
        for t, s in zip(tree_leaves(shapes), tree_leaves(pspecs))])


def _meta_model(cfg: ModelConfig):
    """The model object with its device on ``meta``: its caches and
    parameters are made there, shapes and dtypes only."""
    model = get_model(cfg, device="cpu")
    model.device = torch.device("meta")
    return model


def configure_sp(cfg: ModelConfig, mesh, plan=None) -> None:
    """Arm the sequence-parallel and expert-parallel contexts.

    ``plan`` (a compiled :class:`repro_torch.plan.Plan`, e.g. the one
    ``launch.train.build_mesh`` returns) is forwarded to ``arm_ep`` so
    the EP all-to-all follows the plan's solved shift-ring order.
    """
    from repro_torch.models import layers as L
    from repro_torch.parallel.moe_a2a import arm_ep, clear_ep

    sizes = shd.mesh_axis_sizes(mesh)
    if cfg.sequence_parallel and sizes.get("model", 1) > 1:
        L.set_sequence_parallel(shd.dp_axes(mesh), "model", sizes["model"])
    else:
        L.clear_sequence_parallel()
    if cfg.n_experts and sizes.get("data", 1) > 1:
        arm_ep(mesh, "data", "model" if sizes.get("model", 1) > 1 else None,
               plan=plan)
    else:
        clear_ep()


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Tuple[Any, ...]:
    """:class:`MetaSpec` stand-ins for the step function of this cell:
    ``(state, batch)`` for a train cell, ``(params, tokens[,
    frontend_embeds])`` for prefill, ``(params, tokens, cache)`` for
    decode — the reference's shapes, dtypes and specs."""
    from repro_torch.train.sharded_step import param_shapes

    model = _meta_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    sizes = shd.mesh_axis_sizes(mesh)
    dp_names = shd.dp_axes(mesh)
    dp_total = int(np.prod([sizes[a] for a in dp_names])) if dp_names else 1
    # batch=1 decode (long_500k) cannot shard the batch dim
    dp = shd.batch_spec(mesh) if (dp_total and B % dp_total == 0) else shd.P(None)
    tok2 = shd.P(*dp, None)
    tok1 = shd.P(*dp)
    act = model.dtype

    def frontend_shapes() -> Dict[str, torch.Tensor]:
        if cfg.family == "vlm":
            return {"frontend_embeds": _meta((B, cfg.n_img_tokens, cfg.d_model), act)}
        if cfg.family == "encdec":
            return {"frontend_embeds": _meta((B, cfg.n_audio_ctx, cfg.d_model), act)}
        return {}

    params = param_shapes(model)
    if shape.kind == "train":
        def f32(t):
            return _meta(t.shape, torch.float32)

        leaves = tree_leaves(params)
        count = _meta((), torch.int32)
        state = TrainState(
            params=params,
            opt=OptState(m=tree_unflatten(params, [f32(t) for t in leaves]),
                         v=tree_unflatten(params, [f32(t) for t in leaves]),
                         count=count),
            step=_meta((), torch.int32))
        s_specs = state_pspecs(state, cfg, mesh)
        state_sds = TrainState(
            params=_with_sharding(state.params, s_specs.params, mesh),
            opt=OptState(m=_with_sharding(state.opt.m, s_specs.opt.m, mesh),
                         v=_with_sharding(state.opt.v, s_specs.opt.v, mesh),
                         count=MetaSpec(count, s_specs.opt.count, mesh)),
            step=MetaSpec(state.step, s_specs.step, mesh))
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32), **frontend_shapes()}
        batch_sds = {k: MetaSpec(v, shd.P(*dp, *([None] * (v.dim() - 1))), mesh)
                     for k, v in batch.items()}
        return state_sds, batch_sds

    params_sds = _with_sharding(params, shd.param_pspecs(params, cfg, mesh), mesh)
    if shape.kind == "prefill":
        tok_sds = MetaSpec(_meta((B, S), torch.int32), tok2, mesh)
        extra = frontend_shapes()
        if extra:
            fe = list(extra.values())[0]
            return params_sds, tok_sds, MetaSpec(fe, shd.P(*dp, None, None), mesh)
        return params_sds, tok_sds

    # decode: one new token against an S-long cache
    cache = model.init_cache(B, S)
    cache_sds = _with_sharding(cache, shd.cache_pspecs(cache, cfg, mesh), mesh)
    return params_sds, MetaSpec(_meta((B,), torch.int32), tok1, mesh), cache_sds


def step_callable(cfg: ModelConfig, shape: ShapeSpec, device: Any = "cuda"):
    """The function each cell runs: the train step, prefill or one decode
    step of ``cfg``'s model on ``device``."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    model = get_model(cfg, device=device)
    if shape.kind == "train":
        return make_train_step(model, AdamWConfig())
    if shape.kind == "prefill":
        if cfg.family in ("vlm", "encdec"):
            return lambda params, tokens, fe: model.prefill(params, tokens, fe)
        return lambda params, tokens: model.prefill(params, tokens)
    return lambda params, tokens, cache: model.decode_step(params, tokens, cache)
