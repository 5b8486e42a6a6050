"""Whisper: the encoder/decoder speech transformer, conv front end stubbed
(port of ``repro.models.whisper``).

[arXiv:2212.04356]  The mel-spectrogram convolutions are the reference's
stub: the caller passes frame embeddings ``[B, n_audio_ctx, d_model]``.
Both stacks (LayerNorm, GELU MLPs), the decoder's cross-attention and
the tied LM head (``embed.T``) are the reference's.  The encoder adds
sinusoidal positions, the decoder a learned table (``dec_pos``).

Serving: ``prefill`` encodes the audio once and caches each decoder
layer's cross-attention k/v (``xk``/``xv``, fixed at ``n_audio_ctx``)
beside its self-attention k/v (``k``/``v``, grown by the engine to the
decode headroom).  With ``cfg.attention_impl == "flash"`` the encoder's
self-attention (unmasked) and the decoder's prompt self-attention
(causal) run the flash kernel; cross-attention always runs the plain
grouped attention, as in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

from . import layers as L
from .transformer import lm_loss

__all__ = ["WhisperLM"]

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal encoder positions ``[length, channels]`` (f32)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def _gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]


def _ln(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    return L.layer_norm(x, p["w"], p["b"], eps)


def _cross_decode(p: Params, x: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor, cfg) -> torch.Tensor:
    """Single-query cross-attention against the cached encoder k/v."""
    B = x.shape[0]
    q = (x @ p["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    out = L._sdpa(q, xk, xv, causal=False)
    return out.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]


class WhisperLM:
    """The encoder/decoder LM: ``init`` / ``param_spec`` / ``encode`` /
    ``forward`` / ``loss`` / ``init_cache`` / ``prefill`` / ``decode_step``.

    Parameters are a nested dict of tensors passed to each call, as in the
    reference; the model object holds the config and the device.
    """

    def __init__(self, cfg: ModelConfig, device: Any = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]

    # -- parameters -------------------------------------------------------
    def param_spec(self) -> Params:
        """The parameter tree: ``name -> (shape, init)``, each stack's
        blocks stacked along a leading dimension."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        ln = {"w": ((d,), L.ONES), "b": ((d,), L.ZEROS)}
        mlp = {"w1": ((d, f), ("normal", None)), "b1": ((f,), L.ZEROS),
               "w2": ((f, d), ("normal", None)), "b2": ((d,), L.ZEROS)}
        attn = L.attention_spec(cfg)
        enc = {"ln1": ln, "attn": attn, "ln2": ln, "mlp": mlp}
        dec = {"ln1": ln, "self_attn": attn, "ln_x": ln, "cross_attn": attn,
               "ln2": ln, "mlp": mlp}

        return {
            "embed": ((cfg.vocab_size, d), ("normal", 0.02)),
            "dec_pos": ((cfg.max_positions, d), ("normal", 0.01)),
            "enc_blocks": L.stack_spec(enc, cfg.n_encoder_layers),
            "enc_ln": ln,
            "dec_blocks": L.stack_spec(dec, cfg.n_layers),
            "dec_ln": ln,
        }

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator``, on its device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, "
                             f"the model on {self.device}")
        return L.init_from_spec(generator, self.param_spec(), self.dtype)

    def _remat(self) -> bool:
        return self.cfg.remat == "block" and torch.is_grad_enabled()

    # -- encoder ----------------------------------------------------------
    def _enc_block(self, bp: Params, x: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.norm_eps
        out, _ = L.attention(bp["attn"], _ln(x, bp["ln1"], eps), self.cfg,
                             causal=False, use_rope=False)
        x = x + out
        return x + _gelu_mlp(bp["mlp"], _ln(x, bp["ln2"], eps))

    def encode(self, params: Params, audio_embeds: torch.Tensor) -> torch.Tensor:
        """audio_embeds ``[B, n_audio_ctx, D]`` (the stub front end's output)
        -> the encoder's final-norm states."""
        cfg = self.cfg
        # the frames in the model's dtype: the reference adds the positions
        # in the frames' dtype and lets its matmuls promote (an f32 stub
        # runs a bf16 model's encoder in f32); the port's flash kernel
        # takes the model's dtype
        x = audio_embeds.to(self.dtype) + _sinusoids(
            audio_embeds.shape[1], cfg.d_model, audio_embeds.device).to(self.dtype)
        remat = self._remat()
        for bp in L.unbind_layers(params["enc_blocks"], cfg.n_encoder_layers):
            x = checkpoint(self._enc_block, bp, x, use_reentrant=False) \
                if remat else self._enc_block(bp, x)
        return _ln(x, params["enc_ln"], cfg.norm_eps)

    # -- decoder ----------------------------------------------------------
    def _dec_block(self, bp: Params, x: torch.Tensor, enc_out: torch.Tensor,
                   positions: torch.Tensor):
        cfg = self.cfg
        eps = cfg.norm_eps
        if cfg.sequence_parallel:
            x = L.sp_constrain(x)
        out, kv = L.attention(bp["self_attn"], _ln(x, bp["ln1"], eps), cfg,
                              causal=True, positions=positions, use_rope=False)
        x = x + out
        out, xkv = L.attention(bp["cross_attn"], _ln(x, bp["ln_x"], eps), cfg,
                               kv_override=(enc_out,))
        x = x + out
        return x + _gelu_mlp(bp["mlp"], _ln(x, bp["ln2"], eps)), kv, xkv

    def _dec_input(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        S = tokens.shape[1]
        return params["embed"][tokens] + params["dec_pos"][:S].to(self.dtype)

    def forward(self, params: Params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                return_features: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher forcing: tokens ``[B, S]`` and the audio stub ``[B, A, D]``
        -> (logits ``[B, S, V]`` or the final-norm features, aux loss 0)."""
        cfg = self.cfg
        enc_out = self.encode(params, frontend_embeds)
        x = self._dec_input(params, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)

        def block(bp, x):
            return self._dec_block(bp, x, enc_out, positions)[0]

        remat = self._remat()
        for bp in L.unbind_layers(params["dec_blocks"], cfg.n_layers):
            x = checkpoint(block, bp, x, use_reentrant=False) if remat \
                else block(bp, x)
        x = _ln(x, params["dec_ln"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_features:
            return x, aux
        return x @ params["embed"].T, aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross entropy; the batch carries the audio stub
        as ``"frontend_embeds"`` (``whisper.py:173-180``)."""
        feats, _ = self.forward(params, batch["tokens"], batch["frontend_embeds"],
                                return_features=True)
        return lm_loss(feats, params["embed"].T, batch["labels"],
                       self.cfg.loss_chunk_size)

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, s_max: int, dtype=None) -> Params:
        """Self-attention k/v for ``s_max`` positions and cross-attention
        k/v for the ``n_audio_ctx`` frames."""
        cfg, dev = self.cfg, self.device
        dt = dtype or self.dtype
        n, kv, hd, A = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_audio_ctx

        def zeros(s):
            return torch.zeros((n, batch, kv, s, hd), dtype=dt, device=dev)

        return {"k": zeros(s_max), "v": zeros(s_max), "xk": zeros(A),
                "xv": zeros(A),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
        """Encode the audio, then a teacher-forced pass over the prompt:
        (last-position logits ``[B, V]``, the cache)."""
        cfg = self.cfg
        enc_out = self.encode(params, frontend_embeds)
        x = self._dec_input(params, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        ks, vs, xks, xvs = [], [], [], []
        for bp in L.unbind_layers(params["dec_blocks"], cfg.n_layers):
            x, kv, xkv = self._dec_block(bp, x, enc_out, positions)
            ks.append(kv["k"])
            vs.append(kv["v"])
            xks.append(xkv["k"])
            xvs.append(xkv["v"])
        x = _ln(x[:, -1], params["dec_ln"], cfg.norm_eps)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "xk": torch.stack(xks), "xv": torch.stack(xvs),
                 "pos": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                     device=x.device)}
        return x @ params["embed"].T, cache

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens ``[B]`` -> (logits ``[B, V]``, the cache one position on).

        The new self-attention k/v are written into ``cache``'s buffers in
        place; the returned cache shares them and the cross k/v.
        """
        cfg = self.cfg
        eps = cfg.norm_eps
        pos = cache["pos"]
        x = params["embed"][tokens][:, None, :]
        x = x + params["dec_pos"].index_select(0, pos.reshape(1).long()).to(x.dtype)
        blocks = L.unbind_layers(params["dec_blocks"], cfg.n_layers)
        for i, bp in enumerate(blocks):
            out, _ = L.attention_decode(
                bp["self_attn"], _ln(x, bp["ln1"], eps),
                {"k": cache["k"][i], "v": cache["v"][i]}, pos, cfg, use_rope=False)
            x = x + out
            x = x + _cross_decode(bp["cross_attn"], _ln(x, bp["ln_x"], eps),
                                  cache["xk"][i], cache["xv"][i], cfg)
            x = x + _gelu_mlp(bp["mlp"], _ln(x, bp["ln2"], eps))
        x = _ln(x, params["dec_ln"], eps)
        return (x @ params["embed"].T)[:, 0], {
            "k": cache["k"], "v": cache["v"], "xk": cache["xk"],
            "xv": cache["xv"], "pos": pos + 1}
