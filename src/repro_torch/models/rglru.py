"""RecurrentGemma / Griffin: RG-LRU recurrent blocks and local attention
(port of ``repro.models.rglru``).

[arXiv:2402.19427]  The layers cycle through ``cfg.block_pattern``
(``("R", "R", "A")``): two recurrent blocks a local-attention block.  The
recurrent block is::

    x -> GeLU(W_gate x) * RG-LRU(conv1d_4(W_in x)) -> W_out

with the RG-LRU diagonal recurrence (c = 8)::

    r_t = sigmoid(W_a x_t + b_a)          # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          # input gate
    a_t = exp(-c * softplus(L) * r_t)     # data-dependent decay in (0,1)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The attention block is MQA with RoPE and a sliding window
(``cfg.attn_window``); its prefill runs the flash kernel when
``cfg.attention_impl == "flash"`` (head width 256, the window as its
mask).  Serving keeps O(window) state: each attention layer's k/v live in
a ring buffer of ``W`` slots, slot ``p % W`` holding absolute position
``p`` (k roped at it), and each recurrent layer carries ``h`` and the
conv's last ``W_conv - 1`` inputs.

Parameters keep the reference's layout: the ``n_layers // len(pattern)``
whole groups stacked along a leading dimension under ``"groups"``
(``{"R0", "R1", "A2"}``), the ``n_layers % len(pattern)`` remaining blocks
as a list under ``"tail"``.  The embedding is scaled by ``sqrt(d_model)``
in ``forward``, ``prefill`` and ``decode_step``.

Given a :class:`~repro_torch.parallel.tensor.TensorParallel`, ``loss``
runs over its model axis from model-axis storage, laid out by the
reference's rules: the vocabulary of the embedding and the head; the
recurrent block's ``w_gate``/``w_in``/``w_a``/``w_x`` column-parallel by
channel behind one conjugate identity, its conv, biases and ``lam`` with
them, ``w_out`` row-parallel; the MLP as ``layers.mlp_tp``; the local
attention as ``layers.attention_tp`` (the MQA's one KV head whole).  The
conv and the RG-LRU run every rank's channels in one call, the rank axis
folded into the channels.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.tensor import model_dim, tp_linear, unbind_blocks

from . import layers as L
from .transformer import embed_tp, lm_loss, lm_loss_tp_params

__all__ = ["C_RGLRU", "RecurrentGemmaLM", "rglru_recurrence"]

Params = Dict[str, Any]
C_RGLRU = 8.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# RG-LRU recurrence
# ---------------------------------------------------------------------------

def _prefix_scan(a: torch.Tensor, g: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the maps ``h -> a_t h + g_t`` along dim 2 (f32).

    Returns ``(A, G)`` with ``h_t = A_t h_start + G_t`` for ``h_start``
    the state before the first step: a log-depth doubling scan (step s
    composes each map with the one ``s`` positions before it).
    """
    c = a.shape[2]
    s = 1
    while s < c:
        g = torch.cat([g[:, :, :s], g[:, :, s:] + a[:, :, s:] * g[:, :, :-s]], 2)
        a = torch.cat([a[:, :, :s], a[:, :, s:] * a[:, :, :-s]], 2)
        s *= 2
    return a, g


def rglru_recurrence(
    x: torch.Tensor,          # [B, S, D] (post-conv)
    r_gate: torch.Tensor,     # [B, S, D] sigmoid already applied
    i_gate: torch.Tensor,     # [B, S, D]
    log_lambda: torch.Tensor,  # [D] softplus'd decay parameter (f32)
    h0: Optional[torch.Tensor] = None,   # [B, D] f32
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU diagonal recurrence (``rglru.py:47-94``): ``(y in
    x.dtype, h_last f32)``.

    The reference runs ``lax.scan`` over time.  Here the sequence is cut
    into segments of ``chunk`` tokens (when ``chunk`` divides S and S >
    chunk; one segment otherwise); a doubling scan composes each
    segment's decays and inputs in f32 (``log2(chunk)`` steps, all
    segments at once), a loop over the segments carries ``h`` from one to
    the next, and ``h_t = A_t h_in + G_t``.  With grad enabled the
    segments' scan is checkpointed, so the backward pass keeps the inputs
    and recomputes the scan's steps, as the reference's checkpointed
    segments do.  The gated input's rounding to ``x.dtype`` and the
    ``sqrt(max(1 - a^2, 1e-12))`` are the reference's.
    """
    B, S, D = x.shape
    if h0 is None:
        h0 = torch.zeros((B, D), dtype=torch.float32, device=x.device)
    log_a = (-C_RGLRU * log_lambda[None, None] * r_gate).float()
    a = torch.exp(log_a)
    # the gated input tolerates x.dtype (added once, not compounded); the
    # decay stays f32, it multiplies across up to S steps
    gated = ((i_gate * x).float() * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))).to(x.dtype)
    n = S // chunk if chunk and S % chunk == 0 and S > chunk else 1
    a4 = a.reshape(B, n, S // n, D)
    g4 = gated.float().reshape(B, n, S // n, D)
    if torch.is_grad_enabled() and (a4.requires_grad or g4.requires_grad):
        A, G = checkpoint(_prefix_scan, a4, g4, use_reentrant=False)
    else:
        A, G = _prefix_scan(a4, g4)
    h_in = [h0.float()]
    for j in range(n - 1):
        h_in.append(A[:, j, -1] * h_in[-1] + G[:, j, -1])
    h = A * torch.stack(h_in, 1)[:, :, None] + G
    h = h.reshape(B, S, D)
    return h.to(x.dtype), h[:, -1]


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width ``W``: x ``[B,S,D]``, w ``[W,D]``.

    Returns ``(y, new_state)``, the state the last ``W-1`` inputs
    ``[B, W-1, D]``.  Without a state the conv starts from ``W-1`` zero
    rows (the reference's ``zeros_like(x[:, :W-1])``, which is shorter
    when S < W-1).
    """
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # [B, S+W-1, D]
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(W)) + b
    return y, xp[:, -(W - 1):]


def _to_ring(k: torch.Tensor, W: int, S: int) -> torch.Tensor:
    """The last ``W`` positions of ``[B, KV, S, hd]`` laid out as the decode
    ring buffer: slot ``i`` holds the absolute position ``p`` with
    ``p % W == i`` (zeros after the prompt when ``S <= W``)."""
    if S <= W:
        pad = k.new_zeros(k.shape[:2] + (W - S,) + k.shape[3:])
        return torch.cat([k, pad], dim=2)
    return torch.roll(k[:, :, S - W:], (S - W) % W, dims=2)


class RecurrentGemmaLM:
    """The hybrid LM: ``init`` / ``param_spec`` / ``forward`` / ``loss`` /
    ``init_cache`` / ``prefill`` / ``decode_step``.

    Parameters are a nested dict of tensors passed to each call, as in the
    reference; the model object holds the config and the device.
    """

    def __init__(self, cfg: ModelConfig, device: Any = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        self.pattern = cfg.block_pattern
        self.n_groups, self.n_tail = divmod(cfg.n_layers, len(self.pattern))

    # -- parameters -------------------------------------------------------
    def _rec_block_spec(self) -> Params:
        cfg = self.cfg
        d, normal = cfg.d_model, ("normal", None)
        return {
            "norm": ((d,), L.ONES),
            "w_gate": ((d, d), normal),
            "w_in": ((d, d), normal),
            "conv_w": ((cfg.rglru_conv_width, d), ("normal", 0.1)),
            "conv_b": ((d,), L.ZEROS),
            "w_a": ((d, d), normal),
            "b_a": ((d,), L.ZEROS),
            "w_x": ((d, d), normal),
            "b_x": ((d,), L.ZEROS),
            "lam": ((d,), ("const", 0.7)),           # softplus -> decay
            "w_out": ((d, d), normal),
            "mlp_norm": ((d,), L.ONES),
            "mlp": L.mlp_spec(d, cfg.d_ff),
        }

    def _attn_block_spec(self) -> Params:
        d = self.cfg.d_model
        return {"norm": ((d,), L.ONES), "attn": L.attention_spec(self.cfg),
                "mlp_norm": ((d,), L.ONES), "mlp": L.mlp_spec(d, self.cfg.d_ff)}

    def _block_spec(self, kind: str) -> Params:
        return self._rec_block_spec() if kind == "R" else self._attn_block_spec()

    def param_spec(self) -> Params:
        """The parameter tree: ``name -> (shape, init)``; whole groups
        stacked under ``"groups"``, the remaining blocks listed under
        ``"tail"``."""
        cfg, n = self.cfg, self.n_groups
        group = {f"{kind}{i}": self._block_spec(kind)
                 for i, kind in enumerate(self.pattern)}
        spec: Params = {
            "embed": ((cfg.vocab_size, cfg.d_model), ("normal", 0.02)),
            "groups": L.stack_spec(group, n),
            "final_norm": ((cfg.d_model,), L.ONES),
            "lm_head": ((cfg.d_model, cfg.vocab_size), ("normal", 0.02)),
        }
        if self.n_tail:
            spec["tail"] = [self._block_spec(self.pattern[i])
                            for i in range(self.n_tail)]
        return spec

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator``, on its device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, "
                             f"the model on {self.device}")
        return L.init_from_spec(generator, self.param_spec(), self.dtype)

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens] * math.sqrt(self.cfg.d_model)

    def _groups(self, params: Params) -> list:
        return L.unbind_layers(params["groups"], self.n_groups)

    # -- blocks -----------------------------------------------------------
    def _rec_mix(self, p: Params, h: torch.Tensor, h0=None, conv_state=None):
        """The recurrent block's temporal mix of the normed ``h``: ``(out,
        new_h, new_conv)``."""
        gate = F.gelu(h @ p["w_gate"], approximate="tanh")
        u = h @ p["w_in"]
        u, new_conv = _causal_conv1d(u, p["conv_w"], p["conv_b"], conv_state)
        r_gate = torch.sigmoid(h @ p["w_a"] + p["b_a"])
        i_gate = torch.sigmoid(h @ p["w_x"] + p["b_x"])
        lam = F.softplus(p["lam"].float())
        y, new_h = rglru_recurrence(u, r_gate, i_gate, lam, h0)
        return (gate * y) @ p["w_out"], new_h, new_conv

    def _rec_block_fwd(self, p: Params, x: torch.Tensor, h0=None, conv_state=None):
        cfg = self.cfg
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        out, new_h, new_conv = self._rec_mix(p, h, h0, conv_state)
        x = x + out
        m = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], m), new_h, new_conv

    def _attn_block_fwd(self, p: Params, x: torch.Tensor, positions):
        cfg = self.cfg
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        out, kv = L.attention(p["attn"], h, cfg, causal=True,
                              positions=positions, window=cfg.attn_window)
        x = x + out
        m = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], m), kv

    def _block(self, kind: str, p: Params, x: torch.Tensor, positions,
               tp=None, spec: Optional[Params] = None) -> torch.Tensor:
        """One training block: on one rank, or with ``tp`` over its model
        axis from model-axis storage and the block's ``spec``."""
        if tp is not None:
            return self._block_tp(kind, p, spec, x, positions, tp)
        if kind == "R":
            return self._rec_block_fwd(p, x)[0]
        return self._attn_block_fwd(p, x, positions)[0]

    def _group_fwd(self, gp: Params, x: torch.Tensor, positions, tp=None,
                   spec: Optional[Params] = None) -> torch.Tensor:
        if self.cfg.sequence_parallel:
            x = L.sp_constrain(x)
        for i, kind in enumerate(self.pattern):
            name = f"{kind}{i}"
            x = self._block(kind, gp[name], x, positions, tp,
                            None if spec is None else spec[name])
        return x

    # -- tensor parallelism -------------------------------------------------
    def _rec_mix_tp(self, p: Params, h: torch.Tensor, tp) -> torch.Tensor:
        """The temporal mix over ``tp``'s model axis: the normed ``h``
        through one conjugate identity into the column-parallel
        ``w_gate``/``w_in``/``w_a``/``w_x``; the conv and the RG-LRU on
        every rank's channels at once (rank-major channels are the
        logical order); ``w_out`` row-parallel and all-reduced."""
        m = tp.m
        B, S, d = h.shape
        hm = tp.scatter(h)                                  # [m, B, S, D]

        def fold(t):              # [m, B, S, D/m] -> [B, S, D], rank-major
            return t.permute(1, 2, 0, 3).reshape(B, S, d)

        gate = F.gelu(tp_linear(hm, p["w_gate"]), approximate="tanh")
        u = fold(tp_linear(hm, p["w_in"]))
        u, _ = _causal_conv1d(u, p["conv_w"].permute(1, 0, 2).reshape(-1, d),
                              p["conv_b"].reshape(d))
        r_gate = torch.sigmoid(fold(tp_linear(hm, p["w_a"])) + p["b_a"].reshape(d))
        i_gate = torch.sigmoid(fold(tp_linear(hm, p["w_x"])) + p["b_x"].reshape(d))
        lam = F.softplus(p["lam"].reshape(d).float())
        y, _ = rglru_recurrence(u, r_gate, i_gate, lam)
        y = y.reshape(B, S, m, d // m).permute(2, 0, 1, 3)
        return tp.reduce(tp_linear(gate * y, p["w_out"]))

    def _block_tp(self, kind: str, p: Params, spec: Params, x: torch.Tensor,
                  positions, tp) -> torch.Tensor:
        """One block over ``tp``'s model axis from its storage and specs;
        what a spec leaves replicated runs whole, with no collective."""
        cfg = self.cfg
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        if kind == "A":
            x = x + L.attention_tp(p["attn"], spec["attn"], h, cfg, tp,
                                   positions=positions, window=cfg.attn_window)
        elif model_dim(spec["w_in"]) is None:
            x = x + self._rec_mix(p, h)[0]
        else:
            x = x + self._rec_mix_tp(p, h, tp)
        m = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        return x + L.mlp_tp(p["mlp"], spec["mlp"], m, tp)

    # -- training ---------------------------------------------------------
    def _features(self, params: Params, tokens: torch.Tensor, tp=None
                  ) -> torch.Tensor:
        """The final-norm features ``[B, S, D]``; ``remat="block"``
        checkpoints each group.  With ``tp`` over its model axis from
        model-axis storage (the stacked groups on their per-layer specs,
        the tail on its own)."""
        cfg = self.cfg
        if tp is None:
            x = self._embed(params, tokens)
            groups = [(gp, None) for gp in self._groups(params)]
            tail = [(p, None) for p in params.get("tail", [])]
        else:
            x = embed_tp(params["embed"], tokens, tp) * math.sqrt(cfg.d_model)
            groups = unbind_blocks(params["groups"], tp.pspecs["groups"],
                                   self.n_groups)
            tail = list(zip(params.get("tail", []), tp.pspecs.get("tail", [])))
        positions = torch.arange(tokens.shape[1], device=x.device)
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        for gp, spec in groups:
            if remat:
                x = checkpoint(self._group_fwd, gp, x, positions, tp, spec,
                               use_reentrant=False)
            else:
                x = self._group_fwd(gp, x, positions, tp, spec)
        for i, (p, spec) in enumerate(tail):
            x = self._block(self.pattern[i], p, x, positions, tp, spec)
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps)

    def forward(self, params: Params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                return_features: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] -> (logits [B, S, V] or the final-norm features,
        aux loss 0); ``remat="block"`` checkpoints each group."""
        x = self._features(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_features:
            return x, aux
        return x @ params["lm_head"], aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             tp=None) -> torch.Tensor:
        """Mean next-token cross entropy; never builds the whole logits.
        With ``tp`` over its model axis from model-axis storage (the
        module docstring)."""
        feats = self._features(params, batch["tokens"], tp)
        chunk = self.cfg.loss_chunk_size
        if tp is not None:
            return lm_loss_tp_params(feats, params, batch["labels"], chunk, tp)
        return lm_loss(feats, params["lm_head"], batch["labels"], chunk)

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, s_max: int = 0, dtype=None) -> Params:
        """Recurrent state and ring-buffer window k/v: O(window), not O(S)
        (``s_max`` unused)."""
        cfg, dev = self.cfg, self.device
        dt = dtype or self.dtype
        W, d, cw = cfg.attn_window, cfg.d_model, cfg.rglru_conv_width - 1
        n_rec = sum(1 for k in self.pattern if k == "R")
        n_att = len(self.pattern) - n_rec
        n = self.n_groups
        kv = (n, n_att, batch, cfg.n_kv_heads, W, cfg.head_dim)
        cache: Params = {
            "groups": {
                "h": torch.zeros((n, n_rec, batch, d), dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros((n, n_rec, batch, cw, d), dtype=dt, device=dev),
                "k": torch.zeros(kv, dtype=dt, device=dev),
                "v": torch.zeros(kv, dtype=dt, device=dev),
            },
            "pos": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if self.n_tail:
            n_rec_tail = sum(1 for k in self.pattern[:self.n_tail] if k == "R")
            cache["tail_h"] = torch.zeros((n_rec_tail, batch, d),
                                          dtype=torch.float32, device=dev)
            cache["tail_conv"] = torch.zeros((n_rec_tail, batch, cw, d),
                                             dtype=dt, device=dev)
        return cache

    def grow_cache(self, cache: Params, cur_len: int, new_len: int) -> Params:
        """The serving engine's cache growth: none.  The cache is O(window)
        at every prompt length, P == W included (the reference's engine
        takes a W-slot ring for a P-long buffer there, pads it, and its
        decode fails)."""
        return cache

    def _attn_decode_window(self, p: Params, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            pos: torch.Tensor) -> torch.Tensor:
        """MQA decode against a ring-buffer window cache (``rglru.py:290-325``).

        The new k (roped at ``pos``) and v are written into slot
        ``pos % W`` of ``k_cache``/``v_cache`` in place; each slot's
        absolute position is rebuilt to mask the unwritten, the future and
        the too old.
        """
        cfg = self.cfg
        B, W, hd = x.shape[0], cfg.attn_window, cfg.head_dim
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        q, k_new, v_new = L._qkv(p["attn"], h, cfg)
        cos, sin = L.make_rope(pos[None], hd, cfg.rope_theta)
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
        slot = pos % W
        at = slot.reshape(1).long()
        k_cache.index_copy_(2, at, k_new.to(k_cache.dtype))
        v_cache.index_copy_(2, at, v_new.to(v_cache.dtype))
        idx = torch.arange(W, device=x.device)
        base = pos - slot
        abs_pos = torch.where(idx <= slot, base + idx, base - W + idx)
        valid = (abs_pos >= 0) & (abs_pos <= pos)
        KV = cfg.n_kv_heads
        qh = q.reshape(B, KV, cfg.n_heads // KV, 1, hd)
        scores = torch.einsum("bkgqd,bksd->bkgqs", qh, k_cache).float()
        scores = torch.where(valid, scores / math.sqrt(hd), -1e30)
        probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
        out = torch.einsum("bkgqs,bksd->bkgqd", probs, v_cache)
        out = out.reshape(B, 1, cfg.n_heads * hd)
        x = x + out @ p["attn"]["wo"]
        m = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], m)

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens ``[B]`` -> (logits ``[B, V]``, the cache one position on).

        The window k/v are written into ``cache``'s ring buffers in place
        (the returned cache shares them); ``h`` and the conv states come
        back as new tensors.
        """
        cfg = self.cfg
        pos = cache["pos"]
        gc = cache["groups"]
        x = self._embed(params, tokens)[:, None, :]
        hs, convs = [], []
        for g, gp in enumerate(self._groups(params)):
            ri = ai = 0
            for i, kind in enumerate(self.pattern):
                p = gp[f"{kind}{i}"]
                if kind == "R":
                    x, h, conv = self._rec_block_fwd(
                        p, x, h0=gc["h"][g, ri], conv_state=gc["conv"][g, ri])
                    hs.append(h)
                    convs.append(conv)
                    ri += 1
                else:
                    x = self._attn_decode_window(p, x, gc["k"][g, ai],
                                                 gc["v"][g, ai], pos)
                    ai += 1
        new: Params = {
            "groups": {
                "h": torch.stack(hs).reshape(gc["h"].shape) if hs else gc["h"],
                "conv": torch.stack(convs).reshape(gc["conv"].shape)
                if convs else gc["conv"],
                "k": gc["k"], "v": gc["v"],
            },
            "pos": pos + 1,
        }
        if self.n_tail:
            hs, convs = [], []
            for ri, p in enumerate(params["tail"]):
                if self.pattern[ri] != "R":     # the pattern puts A last
                    raise NotImplementedError("an attention block in the tail")
                x, h, conv = self._rec_block_fwd(
                    p, x, h0=cache["tail_h"][ri], conv_state=cache["tail_conv"][ri])
                hs.append(h)
                convs.append(conv)
            new["tail_h"], new["tail_conv"] = torch.stack(hs), torch.stack(convs)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (x @ params["lm_head"])[:, 0], new

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
        """The prompt ``[B, S]`` -> (last-position logits ``[B, V]``, the
        decode-ready cache: window k/v as ring buffers, ``h``, conv states)."""
        cfg = self.cfg
        S, W = tokens.shape[1], cfg.attn_window
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        outs = []
        for gp in self._groups(params):
            hs, convs, ks, vs = [], [], [], []
            for i, kind in enumerate(self.pattern):
                p = gp[f"{kind}{i}"]
                if kind == "R":
                    x, h, conv = self._rec_block_fwd(p, x)
                    hs.append(h)
                    convs.append(conv)
                else:
                    x, kv = self._attn_block_fwd(p, x, positions)
                    ks.append(_to_ring(kv["k"], W, S))
                    vs.append(_to_ring(kv["v"], W, S))
            outs.append([torch.stack(t) for t in (hs, convs, ks, vs)])
        h, conv, k, v = (torch.stack([o[j] for o in outs]) for j in range(4))
        cache: Params = {
            "groups": {"h": h, "conv": conv, "k": k, "v": v},
            "pos": torch.tensor(S, dtype=torch.int32, device=x.device),
        }
        if self.n_tail:
            hs, convs = [], []
            for p in params["tail"]:
                x, hh, conv1 = self._rec_block_fwd(p, x)
                hs.append(hh)
                convs.append(conv1)
            cache["tail_h"], cache["tail_conv"] = torch.stack(hs), torch.stack(convs)
        x = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        return x @ params["lm_head"], cache
