"""Decoder-only transformer LM, the dense path (port of ``repro.models.transformer``).

GQA attention with RoPE and a gated MLP per block (qwen2-0.5b, glm4-9b,
granite-8b, minitron-8b).  Parameters keep the JAX layout — ``[in, out]``
weights, block parameters stacked along a leading layer dimension — so
:func:`repro_torch.convert.params_from_jax` is a copy.  The layers run
in a Python loop (the reference's ``lax.scan``); ``remat="block"``
checkpoints each block with ``torch.utils.checkpoint``.

It trains (``init``, ``param_spec``, ``forward``, ``loss``) and serves
(``init_cache``, ``prefill``, ``decode_step``: the KV cache keeps the
reference's layout ``{"scan": {"k", "v": [n, B, KV, S, hd]}, "pos"}``).
``cfg.attention_impl == "flash"`` runs the prefill's attention through the
flash kernel, which is forward-only; training keeps ``"xla"``.  The
``vlm`` family (llava-next-mistral-7b) is this decoder with the
reference's anyres stub in front: ``frontend_embeds [B, n_img, D]``
replace the first ``n_img`` token embeddings.  MoE and MLA come with
their slice (ROADMAP.md §1 slice 5, item 8).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

from . import layers as L

__all__ = ["DecoderLM", "lm_loss"]

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DecoderLM:
    """The dense decoder LM: ``init`` / ``param_spec`` / ``forward`` /
    ``loss`` / ``init_cache`` / ``prefill`` / ``decode_step``.

    Parameters are a nested dict of tensors passed to each call, as in the
    reference; the model object holds the config and the device.
    """

    def __init__(self, cfg: ModelConfig, device: Any = "cuda"):
        if cfg.n_experts or cfg.use_mla:
            raise NotImplementedError(
                f"repro_torch's DecoderLM has the dense path only; {cfg.name} "
                f"needs MoE/MLA, queued in ROADMAP.md §1 slice 5, item 8")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]

    # -- parameters -------------------------------------------------------
    def param_spec(self) -> Params:
        """The parameter tree: ``name -> (shape, init)``, blocks stacked."""
        cfg = self.cfg
        d, n = cfg.d_model, cfg.n_layers
        block = {
            "attn_norm": ((d,), L.ONES),
            "mlp_norm": ((d,), L.ONES),
            "attn": L.attention_spec(cfg),
            "mlp": L.mlp_spec(d, cfg.d_ff),
        }
        spec: Params = {
            "embed": ((cfg.vocab_size, d), ("normal", 0.02)),
            "blocks": L.map_spec(block, lambda e: ((n, *e[0]), e[1])),
            "final_norm": ((d,), L.ONES),
        }
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

    # -- blocks -----------------------------------------------------------
    def _block_fwd(self, p: Params, x: torch.Tensor, positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, Params]:
        """One block over the whole sequence: ``(x, its roped k/v)``."""
        cfg = self.cfg
        h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        attn_out, kv = L.attention(p["attn"], h, cfg, causal=True,
                                   positions=positions, window=cfg.attn_window)
        x = x + attn_out
        h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h), kv

    def _block_decode(self, p: Params, x: torch.Tensor, layer_cache: Params,
                      pos: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        attn_out, _ = L.attention_decode(p["attn"], h, layer_cache, pos, cfg)
        x = x + attn_out
        h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h)

    def _embed(self, params: Params, tokens: torch.Tensor,
               frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """Token embeddings; for the ``vlm`` family the anyres stub
        (``transformer.py:105-113``): the image embeddings replace the
        first ``n_img`` slots."""
        x = params["embed"][tokens]
        if self.cfg.family == "vlm" and frontend_embeds is not None:
            n_img = frontend_embeds.shape[1]
            x = torch.cat([frontend_embeds.to(x.dtype), x[:, n_img:]], dim=1)
        return x

    def _features(self, params: Params, tokens: torch.Tensor,
                  frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final-norm hidden states ``[B, S, D]``."""
        cfg = self.cfg
        x = self._embed(params, tokens, frontend_embeds)
        positions = torch.arange(tokens.shape[1], device=x.device)
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        for bp in L.unbind_layers(params["blocks"], cfg.n_layers):
            if remat:
                x, _ = checkpoint(self._block_fwd, bp, x, positions,
                                  use_reentrant=False)
            else:
                x, _ = self._block_fwd(bp, x, positions)
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps)

    def forward(self, params: Params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                return_features: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] -> (logits [B, S, V], aux loss 0)."""
        x = self._features(params, tokens, frontend_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_features:
            return x, aux
        return x @ self._head(params), aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross entropy; never builds the whole logits."""
        feats = self._features(params, batch["tokens"],
                               batch.get("frontend_embeds"))
        return lm_loss(feats, self._head(params), batch["labels"],
                       self.cfg.loss_chunk_size)

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, s_max: int, dtype=None) -> Params:
        """An empty KV cache for ``s_max`` positions."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, s_max, cfg.head_dim)
        dt = dtype or self.dtype

        def zeros():
            return torch.zeros(shape, dtype=dt, device=self.device)

        return {"scan": {"k": zeros(), "v": zeros()},
                "pos": torch.zeros((), dtype=torch.int32, device=self.device)}

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
        """The prompt ``[B, S]`` -> (last-position logits ``[B, V]``, the
        cache sized to the prompt with every layer's roped k and v)."""
        cfg = self.cfg
        x = self._embed(params, tokens, frontend_embeds)
        positions = torch.arange(tokens.shape[1], device=x.device)
        ks, vs = [], []
        for bp in L.unbind_layers(params["blocks"], cfg.n_layers):
            x, kv = self._block_fwd(bp, x, positions)
            ks.append(kv["k"])
            vs.append(kv["v"])
        x = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        cache = {"scan": {"k": torch.stack(ks), "v": torch.stack(vs)},
                 "pos": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                     device=x.device)}
        return x @ self._head(params), cache

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens ``[B]`` -> (logits ``[B, V]``, the cache one position on).

        The new k/v are written into ``cache``'s buffers in place; the
        returned cache shares them and carries ``pos + 1``.
        """
        cfg = self.cfg
        if cfg.attn_window:
            raise NotImplementedError("windowed decode lives in the hybrid model")
        pos = cache["pos"]
        ks, vs = cache["scan"]["k"], cache["scan"]["v"]
        x = params["embed"][tokens][:, None, :]
        for i, bp in enumerate(L.unbind_layers(params["blocks"], cfg.n_layers)):
            x = self._block_decode(bp, x, {"k": ks[i], "v": vs[i]}, pos)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (x @ self._head(params))[:, 0], {"scan": {"k": ks, "v": vs},
                                                "pos": pos + 1}


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
    if chunk <= 0 or S <= chunk or S % chunk != 0:
        return _xent(features @ head, labels)
    total = torch.zeros((), dtype=torch.float32, device=features.device)
    for i in range(0, S, chunk):
        total = total + checkpoint(_chunk_loss, features[:, i:i + chunk],
                                   head, labels[:, i:i + chunk],
                                   use_reentrant=False)
    return total / (B * S)
