"""Decoder-only transformer LM: dense, MoE, MLA, VLM (port of ``repro.models.transformer``).

GQA attention with RoPE and a gated MLP per block (qwen2-0.5b, glm4-9b,
granite-8b, minitron-8b); MoE blocks (dbrx-132b); MLA with MoE
(deepseek-v2-236b).  Parameters keep the JAX layout — ``[in, out]``
weights, block parameters stacked along a leading layer dimension — so
:func:`repro_torch.convert.params_from_jax` is a copy.  An MoE model's
leading ``n_dense_layers`` blocks (deepseek's first, with ``d_ff``) are a
list, ``"head_blocks"``, run before the stacked ``"blocks"``, as the
reference unrolls them.  The layers run in a Python loop (the reference's
``lax.scan``); ``remat="block"`` checkpoints each block with
``torch.utils.checkpoint``.

It trains (``init``, ``param_spec``, ``forward``, ``loss`` = cross entropy
+ 0.01 x the routers' aux loss) and serves (``init_cache``, ``prefill``,
``decode_step``: the cache keeps the reference's layout ``{"scan": {"k",
"v": [n, B, KV, S, hd]}, "pos"}``, with MLA's latents ``"ckv"`` and
``"k_rope"`` in place of k/v and a ``"head"`` sub-tree for the head
blocks).  ``cfg.attention_impl == "flash"`` runs the prefill's GQA
attention through the flash kernel, which is forward-only; training keeps
``"xla"``.  MLA's q/k head width (nope + rope, 192 for deepseek) is not a
flash width, so MLA keeps its two-term attention, as the reference does.
The ``vlm`` family (llava-next-mistral-7b) is this decoder with the
reference's anyres stub in front: ``frontend_embeds [B, n_img, D]``
replace the first ``n_img`` token embeddings.  Given a
:class:`~repro_torch.parallel.tensor.TensorParallel`, ``loss`` runs the
dense family, the VLM and MoE (GQA or MLA attention) over a model axis
from sharded storage (:func:`lm_loss_tp`, ``layers.attention_tp``/
``mla_attention_tp``/``mlp_tp``, the experts gathered by
``layers.moe_layer``, an MoE model's head blocks on their own specs); ``loss_ranks`` runs every data
rank of an armed EP mesh in one graph, each on its own view of the
parameters (the EP train step's).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.tensor import (
    model_dim, require_tp_family, tp_linear, unbind_blocks)

from . import layers as L

__all__ = ["DecoderLM", "embed_tp", "lm_loss", "lm_loss_tp",
           "lm_loss_tp_params"]

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DecoderLM:
    """The decoder LM: ``init`` / ``param_spec`` / ``forward`` / ``loss`` /
    ``init_cache`` / ``prefill`` / ``decode_step``.

    Parameters are a nested dict of tensors passed to each call, as in the
    reference; the model object holds the config and the device.
    """

    def __init__(self, cfg: ModelConfig, device: Any = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        #: leading dense blocks of an MoE model, then the stacked blocks
        self.n_head = cfg.n_dense_layers if cfg.n_experts else 0
        self.n_scan = cfg.n_layers - self.n_head

    # -- parameters -------------------------------------------------------
    def _block_spec(self, moe: bool) -> Params:
        cfg = self.cfg
        d = cfg.d_model
        return {
            "attn_norm": ((d,), L.ONES),
            "mlp_norm": ((d,), L.ONES),
            "attn": L.mla_spec(cfg) if cfg.use_mla else L.attention_spec(cfg),
            **({"moe": L.moe_spec(cfg)} if moe else
               {"mlp": L.mlp_spec(d, cfg.d_ff)}),
        }

    def param_spec(self) -> Params:
        """The parameter tree: ``name -> (shape, init[, dtype])``, blocks
        stacked, head blocks a list."""
        cfg = self.cfg
        d = cfg.d_model
        spec: Params = {
            "embed": ((cfg.vocab_size, d), ("normal", 0.02)),
            "blocks": L.stack_spec(self._block_spec(cfg.n_experts > 0),
                                   self.n_scan),
            "final_norm": ((d,), L.ONES),
        }
        if self.n_head:
            spec["head_blocks"] = [self._block_spec(False)
                                   for _ in range(self.n_head)]
        if not cfg.tie_embeddings:
            spec["lm_head"] = ((d, cfg.vocab_size), ("normal", 0.02))
        return spec

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator``, on its device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, "
                             f"the model on {self.device}")
        return L.init_from_spec(generator, self.param_spec(), self.dtype)

    def _head(self, params: Params) -> torch.Tensor:
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def _layers(self, params: Params) -> List[Tuple[str, Params]]:
        """``(cache sub-tree, block)`` of every layer in order."""
        return ([("head", bp) for bp in params.get("head_blocks", [])]
                + [("scan", bp)
                   for bp in L.unbind_layers(params["blocks"], self.n_scan)])

    # -- blocks -----------------------------------------------------------
    def _ffn(self, p: Params, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if "moe" in p:
            return L.moe_layer(p["moe"], h, self.cfg)
        return L.mlp(p["mlp"], h), torch.zeros((), dtype=torch.float32,
                                               device=h.device)

    def _attend(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
                tp=None, spec: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Params]:
        """The block's first half: ``x`` plus its attention, and the cache
        entries (none under ``tp``)."""
        cfg = self.cfg
        if cfg.sequence_parallel:
            x = L.sp_constrain(x)
        h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        if tp is not None and cfg.use_mla:
            return x + L.mla_attention_tp(p["attn"], spec["attn"], h, cfg, tp,
                                          positions=positions), {}
        if tp is not None:
            return x + L.attention_tp(p["attn"], spec["attn"], h, cfg, tp,
                                      positions=positions,
                                      window=cfg.attn_window), {}
        if cfg.use_mla:
            attn_out, kv = L.mla_attention(p["attn"], h, cfg, positions)
        else:
            attn_out, kv = L.attention(p["attn"], h, cfg, causal=True,
                                       positions=positions,
                                       window=cfg.attn_window)
        return x + attn_out, kv

    def _block_fwd(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
                   tp=None, spec: Optional[Params] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
        """One block over the whole sequence: ``(x, aux, its cache
        entries)`` — roped k/v, or MLA's latents.  With ``tp`` (a
        :class:`~repro_torch.parallel.tensor.TensorParallel`) the block
        runs over its model axis from model-axis storage, ``spec`` the
        block's specs, and returns no cache entries."""
        cfg = self.cfg
        x, kv = self._attend(p, x, positions, tp, spec)
        h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        if tp is None:
            y, aux = self._ffn(p, h)
        elif "moe" in p:
            y, aux = L.moe_layer(p["moe"], h, cfg, tp=tp)
        else:
            y, aux = L.mlp_tp(p["mlp"], spec["mlp"], h, tp), torch.zeros(
                (), dtype=torch.float32, device=x.device)
        return x + y, aux, kv

    def _blocks_ranks(self, ps: List[Params], xs: List[torch.Tensor],
                      positions: torch.Tensor, tp=None,
                      spec: Optional[Params] = None
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """One block on every data rank's rows, rank ``r`` reading its own
        view ``ps[r]`` of the block's parameters; an MoE block's layer is
        the EP all-to-all over the ranks
        (:func:`~repro_torch.parallel.moe_a2a.moe_ranks`) where EP is
        armed, else the dense dispatch with the whole batch's aux
        (:func:`~repro_torch.models.layers.moe_dense_ranks`), the rest
        rank by rank."""
        from repro_torch.parallel.moe_a2a import ep_armed, moe_ranks

        cfg = self.cfg
        xs = [self._attend(p, x, positions, tp, spec)[0]
              for p, x in zip(ps, xs)]
        hs = [L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
              for p, x in zip(ps, xs)]
        if "moe" in ps[0]:
            layer = moe_ranks if ep_armed(cfg) else L.moe_dense_ranks
            ys, aux = layer([p["moe"] for p in ps], hs, cfg, tp)
        else:
            ys = [L.mlp(p["mlp"], h) if tp is None else
                  L.mlp_tp(p["mlp"], spec["mlp"], h, tp)
                  for p, h in zip(ps, hs)]
            aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        return [x + y for x, y in zip(xs, ys)], aux

    def _block_decode(self, p: Params, x: torch.Tensor, layer_cache: Params,
                      pos: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        if cfg.use_mla:
            attn_out, _ = L.mla_attention_decode(p["attn"], h, layer_cache,
                                                 pos, cfg)
        else:
            attn_out, _ = L.attention_decode(p["attn"], h, layer_cache, pos, cfg)
        x = x + attn_out
        y, _ = self._ffn(p, L.rms_norm(x, p["mlp_norm"], cfg.norm_eps))
        return x + y

    def _embed(self, params: Params, tokens: torch.Tensor,
               frontend_embeds: Optional[torch.Tensor], tp=None) -> torch.Tensor:
        """Token embeddings; for the ``vlm`` family the anyres stub
        (``transformer.py:105-113``): the image embeddings replace the
        first ``n_img`` slots."""
        x = (params["embed"][tokens] if tp is None else
             embed_tp(params["embed"], tokens, tp))
        if self.cfg.family == "vlm" and frontend_embeds is not None:
            n_img = frontend_embeds.shape[1]
            x = torch.cat([frontend_embeds.to(x.dtype), x[:, n_img:]], dim=1)
        return x

    def _layer_list(self, params: Params, tp=None
                    ) -> List[Tuple[str, Params, Optional[Params]]]:
        """``(where, block, spec)`` of every layer in order: the head
        blocks, then the stacked ones (from model-axis storage under
        ``tp``, a head block's specs its own unstacked ones)."""
        if tp is None:
            return [(w, bp, None) for w, bp in self._layers(params)]
        head = [("head", bp, spec) for bp, spec in zip(
            params.get("head_blocks", []), tp.pspecs.get("head_blocks", []))]
        return head + [("scan", bp, spec) for bp, spec in unbind_blocks(
            params["blocks"], tp.pspecs["blocks"], self.n_scan)]

    def _features(self, params: Params, tokens: torch.Tensor,
                  frontend_embeds: Optional[torch.Tensor] = None, tp=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final-norm hidden states ``[B, S, D]`` and the summed aux loss.

        The head blocks run unchecked, the stacked ones under
        ``remat="block"`` checkpointed, as the reference's scan body."""
        cfg = self.cfg
        x = self._embed(params, tokens, frontend_embeds, tp)
        positions = torch.arange(tokens.shape[1], device=x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        for where, bp, spec in self._layer_list(params, tp):
            if remat and where == "scan":
                x, aux, _ = checkpoint(self._block_fwd, bp, x, positions, tp,
                                       spec, use_reentrant=False)
            else:
                x, aux, _ = self._block_fwd(bp, x, positions, tp, spec)
            aux_total = aux_total + aux
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total

    def forward(self, params: Params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                return_features: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] -> (logits [B, S, V], aux loss)."""
        x, aux = self._features(params, tokens, frontend_embeds)
        if return_features:
            return x, aux
        return x @ self._head(params), aux

    def _ce(self, params: Params, feats: torch.Tensor, labels: torch.Tensor,
            tp=None) -> torch.Tensor:
        chunk = self.cfg.loss_chunk_size
        if tp is None:
            return lm_loss(feats, self._head(params), labels, chunk)
        return lm_loss_tp_params(feats, params, labels, chunk, tp,
                                 self.cfg.tie_embeddings)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             tp=None) -> torch.Tensor:
        """Mean next-token cross entropy + 0.01 x the aux loss; never
        builds the whole logits.

        With ``tp`` (a :class:`~repro_torch.parallel.tensor.TensorParallel`)
        ``params`` is its model-axis storage
        (:func:`~repro_torch.parallel.tensor.shard_params`) and the loss
        runs over the model axis: the vocab-parallel lookup and cross
        entropy, column- and row-parallel blocks, MoE layers with their
        experts gathered over the model axis, whatever the specs leave
        replicated computed whole.  The dense family, the VLM and MoE
        (:func:`~repro_torch.parallel.tensor.require_tp_family`).
        """
        if tp is not None:
            require_tp_family(self.cfg)
        feats, aux = self._features(params, batch["tokens"],
                                    batch.get("frontend_embeds"), tp)
        return self._ce(params, feats, batch["labels"], tp) + 0.01 * aux

    def loss_ranks(self, rank_params: List[Params],
                   batches: List[Dict[str, torch.Tensor]], tp=None
                   ) -> List[torch.Tensor]:
        """Each data rank's :meth:`loss` on its rows, in one autograd graph
        over all of them: rank ``r`` reads its own view ``rank_params[r]``
        of the parameters (model-axis storage under ``tp``), and the MoE
        layers run the armed EP all-to-all across the ranks, so the aux
        term every rank adds is the mean over all of them (the
        reference's ``pmean``); without EP they run the dense dispatch
        with the whole batch's aux.  Each stacked block is checkpointed
        over all ranks at once (``remat="block"``)."""
        cfg = self.cfg
        if tp is not None:
            require_tp_family(cfg)
        xs = [self._embed(p, b["tokens"], b.get("frontend_embeds"), tp)
              for p, b in zip(rank_params, batches)]
        positions = torch.arange(batches[0]["tokens"].shape[1],
                                 device=xs[0].device)
        aux_total = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        layers = [self._layer_list(p, tp) for p in rank_params]
        for i, (where, _, spec) in enumerate(layers[0]):
            bps = [rank[i][1] for rank in layers]
            if remat and where == "scan":
                xs, aux = checkpoint(self._blocks_ranks, bps, xs, positions,
                                     tp, spec, use_reentrant=False)
            else:
                xs, aux = self._blocks_ranks(bps, xs, positions, tp, spec)
            aux_total = aux_total + aux
        return [self._ce(p, L.rms_norm(x, p["final_norm"], cfg.norm_eps),
                         b["labels"], tp) + 0.01 * aux_total
                for p, x, b in zip(rank_params, xs, batches)]

    # -- serving ----------------------------------------------------------
    def _cache_leaves(self, n: int, batch: int, s_max: int, dtype) -> Params:
        cfg = self.cfg

        def zeros(*shape):
            return torch.zeros((n, batch, *shape), dtype=dtype,
                               device=self.device)

        if cfg.use_mla:
            return {"ckv": zeros(s_max, cfg.kv_lora_rank),
                    "k_rope": zeros(s_max, cfg.qk_rope_head_dim)}
        kv = (cfg.n_kv_heads, s_max, cfg.head_dim)
        return {"k": zeros(*kv), "v": zeros(*kv)}

    def init_cache(self, batch: int, s_max: int, dtype=None) -> Params:
        """An empty cache for ``s_max`` positions."""
        dt = dtype or self.dtype
        cache: Params = {
            "scan": self._cache_leaves(self.n_scan, batch, s_max, dt),
            "pos": torch.zeros((), dtype=torch.int32, device=self.device)}
        if self.n_head:
            cache["head"] = self._cache_leaves(self.n_head, batch, s_max, dt)
        return cache

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
        """The prompt ``[B, S]`` -> (last-position logits ``[B, V]``, the
        cache sized to the prompt with every layer's roped k and v, or
        MLA's latents)."""
        cfg = self.cfg
        x = self._embed(params, tokens, frontend_embeds)
        positions = torch.arange(tokens.shape[1], device=x.device)
        kvs: Dict[str, List[Params]] = {"head": [], "scan": []}
        for where, bp in self._layers(params):
            x, _, kv = self._block_fwd(bp, x, positions)
            kvs[where].append(kv)
        x = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        cache: Params = {"pos": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                             device=x.device)}
        for where, entries in kvs.items():
            if entries:
                cache[where] = {k: torch.stack([e[k] for e in entries])
                                for k in entries[0]}
        return x @ self._head(params), cache

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens ``[B]`` -> (logits ``[B, V]``, the cache one position on).

        The new entries are written into ``cache``'s buffers in place; the
        returned cache shares them and carries ``pos + 1``.
        """
        cfg = self.cfg
        if cfg.attn_window:
            raise NotImplementedError("windowed decode lives in the hybrid model")
        pos = cache["pos"]
        x = params["embed"][tokens][:, None, :]
        seen = {"head": 0, "scan": 0}
        for where, bp in self._layers(params):
            i = seen[where]
            seen[where] += 1
            layer_cache = {k: v[i] for k, v in cache[where].items()}
            x = self._block_decode(bp, x, layer_cache, pos)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        new_cache = {k: v for k, v in cache.items() if k != "pos"}
        new_cache["pos"] = pos + 1
        return (x @ self._head(params))[:, 0], new_cache


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _chunk_loss(xi: torch.Tensor, head: torch.Tensor,
                li: torch.Tensor) -> torch.Tensor:
    # f32 logits from the model-dtype operands (the reference's
    # preferred_element_type=f32): a bf16 matmul would round its output,
    # so both operands are upcast here, inside the checkpointed chunk
    logits = xi.float() @ head.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def lm_loss(features: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
            chunk: int = 0) -> torch.Tensor:
    """Cross entropy from final hidden states, never materialising the
    full ``[B, S, V]`` logits: sequence chunks are projected and reduced
    inside a checkpoint, so the peak is ``[B, chunk, V]`` in f32 in the
    forward and the backward pass."""
    B, S, _ = features.shape
    if head.dim() == 2:
        head = L.sp_head_constrain(head)
    if chunk <= 0 or S <= chunk or S % chunk != 0:
        return _xent(features @ head, labels)
    total = torch.zeros((), dtype=torch.float32, device=features.device)
    for i in range(0, S, chunk):
        total = total + checkpoint(_chunk_loss, features[:, i:i + chunk],
                                   head, labels[:, i:i + chunk],
                                   use_reentrant=False)
    return total / (B * S)


def _vocab_parallel_xent(x: torch.Tensor, head: torch.Tensor,
                         labels: torch.Tensor, tp, upcast: bool) -> torch.Tensor:
    """Per-token ``logz - gold`` ``[B, c]`` from ``x [B, c, D]`` and the
    vocab-sharded ``head [m, D, V/m]``: each rank's logits over its slice
    of the vocabulary; the ranks' ``logsumexp`` all-gathered and reduced
    again over the ``m`` values; the gold logit, zero outside its rank's
    slice, all-reduced.  ``upcast`` casts the operands to f32 (the chunked
    path's), else the model-dtype logits are upcast (``_xent``'s)."""
    m, vl = head.shape[0], head.shape[2]
    if upcast:
        logits = tp_linear(tp.scatter(x.float()), head.float())
    else:
        logits = tp_linear(tp.scatter(x), head).float()
    logz = torch.logsumexp(tp.gather(torch.logsumexp(logits, dim=-1)), dim=0)
    rank = torch.arange(m, device=x.device)[:, None, None]
    loc = labels[None].long() - rank * vl
    ok = (loc >= 0) & (loc < vl)
    gold = torch.gather(logits, -1, loc.clamp(0, vl - 1)[..., None])[..., 0]
    return logz - tp.reduce(torch.where(ok, gold, gold.new_zeros(())))


def _chunk_loss_tp(xi: torch.Tensor, head: torch.Tensor, li: torch.Tensor,
                   tp) -> torch.Tensor:
    return torch.sum(_vocab_parallel_xent(xi, head, li, tp, upcast=True))


def lm_loss_tp(features: torch.Tensor, head: torch.Tensor,
               labels: torch.Tensor, chunk: int, tp) -> torch.Tensor:
    """:func:`lm_loss` over the model axis of ``tp`` with a vocab-sharded
    ``head [m, D, V/m]``, chunked and checkpointed as :func:`lm_loss`
    (a chunk's recompute runs its gather and all-reduce again)."""
    B, S, _ = features.shape
    if chunk <= 0 or S <= chunk or S % chunk != 0:
        return torch.mean(_vocab_parallel_xent(features, head, labels, tp,
                                               upcast=False))
    total = torch.zeros((), dtype=torch.float32, device=features.device)
    for i in range(0, S, chunk):
        total = total + checkpoint(_chunk_loss_tp, features[:, i:i + chunk],
                                   head, labels[:, i:i + chunk], tp,
                                   use_reentrant=False)
    return total / (B * S)


# ---------------------------------------------------------------------------
# the vocabulary over a model axis: every family's embedding and head
# ---------------------------------------------------------------------------

def embed_tp(table: torch.Tensor, tokens: torch.Tensor, tp) -> torch.Tensor:
    """The token embeddings ``[B, S, D]`` from ``tp``'s storage of
    ``table``: vocab-parallel where the spec of ``embed`` shards the
    vocabulary (rank ``j`` holds rows ``j*V/m ..`` of ``table [m, V/m,
    D]`` and contributes them, zeros elsewhere; the ranks' rows are
    all-reduced), else the replicated lookup."""
    if model_dim(tp.pspecs["embed"]) is None:
        return table[tokens]
    m, vl = table.shape[0], table.shape[1]
    rank = torch.arange(m, device=tokens.device)[:, None, None]
    loc = tokens[None] - rank * vl
    ok = (loc >= 0) & (loc < vl)
    rows = table[rank, loc.clamp(0, vl - 1)]               # [m, B, S, D]
    return tp.reduce(torch.where(ok[..., None], rows, rows.new_zeros(())))


def lm_loss_tp_params(features: torch.Tensor, params: Params,
                      labels: torch.Tensor, chunk: int, tp,
                      tie_embeddings: bool = False) -> torch.Tensor:
    """:func:`lm_loss` from ``tp``'s storage of a model's parameters: the
    unembedding is ``lm_head`` (or, tied, the embedding transposed), and
    where its spec shards the vocabulary the loss is
    :func:`lm_loss_tp`'s, else the replicated :func:`lm_loss`."""
    name = "embed" if tie_embeddings else "lm_head"
    sharded = model_dim(tp.pspecs[name]) is not None
    head = params[name]
    if tie_embeddings:
        head = head.transpose(1, 2) if sharded else head.T
    if sharded:
        return lm_loss_tp(features, head, labels, chunk, tp)
    return lm_loss(features, head, labels, chunk)
