"""RWKV6 "Finch": attention-free LM with data-dependent decay (port of ``repro.models.rwkv6``).

[arXiv:2404.05892]  Per block: TimeMix (the WKV linear-attention state
recurrence with LoRA-produced, data-dependent per-channel decay ``w_t``)
and ChannelMix (squared-ReLU FFN with token shift).

Parameters keep the JAX layout: ``[in, out]`` weights used as ``x @ w``,
and every block parameter stacked along a leading layer dimension, so
:func:`repro_torch.convert.params_from_jax` is a copy.  The layers run in
a Python loop (the reference's ``lax.scan``).

Prefill with ``wkv_impl="kernel"`` runs the chunked CUDA kernel
(:mod:`repro_torch.kernels.rwkv6_chunked`), which returns the final WKV
state; decode runs the exact recurrence on that state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import wkv_chunked_op
from repro_torch.kernels.ref import wkv_recurrence

from . import layers as L

__all__ = ["LORA_R", "Rwkv6LM", "wkv_recurrence"]

Params = Dict[str, Any]

LORA_R = 32  # decay / token-shift LoRA rank

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _shift(x: torch.Tensor, init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros or carried state at t=0).  x: [B,S,D]."""
    pad = torch.zeros_like(x[:, :1]) if init is None else init[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a tree of stacked block parameters."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _map_spec(spec, fn):
    return {k: _map_spec(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in spec.items()}


class Rwkv6LM:
    """The RWKV6 LM: ``init`` / ``forward`` / ``prefill`` / ``decode_step``.

    Parameters are a nested dict of tensors passed to each call, as in the
    reference; the model object holds the config and the device.
    """

    def __init__(self, cfg: ModelConfig, device: Any = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        self.n_heads = cfg.d_model // cfg.rwkv_head_dim
        self.head_dim = cfg.rwkv_head_dim

    # -- parameters -------------------------------------------------------
    def param_spec(self) -> Params:
        """The parameter tree: ``name -> (shape, init)``, blocks stacked.

        ``init`` is ``("normal", scale)`` (``scale=None``: 1/sqrt(fan-in))
        or ``("const", value)``.  It is the schema the converter checks.
        """
        cfg = self.cfg
        d, n, H, K, R = (cfg.d_model, cfg.n_layers, self.n_heads,
                         self.head_dim, LORA_R)
        zeros, ones = ("const", 0.0), ("const", 1.0)
        tm = {
            "maa_x": ((d,), zeros),
            "maa": ((5, d), zeros),                  # w, k, v, r, g
            "maa_A": ((d, 5 * R), ("normal", 0.01)),
            "maa_B": ((5, R, d), ("normal", 0.01)),
            "w0": ((d,), ("const", -6.0)),           # w = exp(-exp(w0 + ...))
            "wA": ((d, 2 * R), ("normal", 0.01)),
            "wB": ((2 * R, d), ("normal", 0.01)),
            "u": ((H, K), zeros),                    # time_faaaa bonus
            "wr": ((d, d), ("normal", None)),
            "wk": ((d, d), ("normal", None)),
            "wv": ((d, d), ("normal", None)),
            "wg": ((d, d), ("normal", None)),
            "wo": ((d, d), ("normal", None)),
            "ln_x_w": ((H, K), ones),                # per-head GroupNorm
            "ln_x_b": ((H, K), zeros),
        }
        cm = {
            "maa_k": ((d,), zeros),
            "maa_r": ((d,), zeros),
            "wk": ((d, cfg.d_ff), ("normal", None)),
            "wv": ((cfg.d_ff, d), ("normal", None)),
            "wr": ((d, d), ("normal", None)),
        }
        block = {"ln1": ((d,), ones), "ln2": ((d,), ones),
                 "time_mix": tm, "channel_mix": cm}
        return {
            "embed": ((cfg.vocab_size, d), ("normal", 0.02)),
            "blocks": _map_spec(block, lambda e: ((n, *e[0]), e[1])),
            "final_norm": ((d,), ones),
            "lm_head": ((d, cfg.vocab_size), ("normal", 0.02)),
        }

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator``, on its device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, "
                             f"the model on {self.device}")

        def make(entry):
            shape, (kind, val) = entry
            if kind == "const":
                return torch.full(shape, val, dtype=self.dtype,
                                  device=generator.device)
            # scale None: 1/sqrt(fan-in), the `in` of a stacked [L, in, out]
            scale = shape[-2] ** -0.5 if val is None else val
            return L.dense_init(generator, shape, scale=scale, dtype=self.dtype)

        return _map_spec(self.param_spec(), make)

    # -- time mix ---------------------------------------------------------
    def _time_mix_inputs(self, p: Params, x, sx):
        """Project token-shifted inputs to (r, k, v, w, g)."""
        dx = sx - x
        xxx = x + dx * p["maa_x"]
        dd = torch.tanh(xxx @ p["maa_A"])                      # [B,S,5R]
        B_, S_, _ = dd.shape
        dd = dd.reshape(B_, S_, 5, LORA_R).permute(2, 0, 1, 3)
        offsets = torch.einsum("nbsr,nrd->nbsd", dd, p["maa_B"])  # [5,B,S,D]
        mixed = x[None] + dx[None] * (p["maa"][:, None, None, :] + offsets)
        x_w, x_k, x_v, x_r, x_g = mixed.unbind(0)
        r = x_r @ p["wr"]
        k = x_k @ p["wk"]
        v = x_v @ p["wv"]
        g = F.silu(x_g @ p["wg"])
        w = torch.exp(-torch.exp(
            (p["w0"] + torch.tanh(x_w @ p["wA"]) @ p["wB"]).float()))
        return r, k, v, w, g

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        B, S, _ = t.shape
        return t.reshape(B, S, self.n_heads, self.head_dim)

    def _time_mix(self, p, x, sx_init=None, state=None):
        cfg = self.cfg
        B, S, d = x.shape
        sx = _shift(x, sx_init)
        r, k, v, w, g = self._time_mix_inputs(p, x, sx)
        heads = (self._heads(r), self._heads(k), self._heads(v),
                 self._heads(w.to(x.dtype)))
        if (cfg.wkv_impl == "kernel" and state is None and S > 1
                and S % 16 == 0):
            # chunked CUDA kernel (fresh state); it returns the final state
            y, new_state = wkv_chunked_op(*heads, p["u"])
        else:
            y, new_state = wkv_recurrence(*heads, p["u"], state)
        # per-head GroupNorm over the head_dim channels, in f32
        yf = y.float()
        mu = yf.mean(-1, keepdim=True)
        var = yf.var(-1, keepdim=True, correction=0)
        yf = (yf - mu) * torch.rsqrt(var + 1e-5)
        y = (yf * p["ln_x_w"].float() + p["ln_x_b"].float()).to(y.dtype)
        y = y.reshape(B, S, d)
        y = (y * g) @ p["wo"]
        return y, x[:, -1], new_state

    def _channel_mix(self, p, x, sx_init=None):
        sx = _shift(x, sx_init)
        dx = sx - x
        x_k = x + dx * p["maa_k"]
        x_r = x + dx * p["maa_r"]
        k = torch.square(torch.relu(x_k @ p["wk"]))
        out = torch.sigmoid(x_r @ p["wr"]) * (k @ p["wv"])
        return out, x[:, -1]

    def _block(self, bp, x, att_sx=None, ffn_sx=None, wkv=None):
        eps = self.cfg.norm_eps
        h = L.rms_norm(x, bp["ln1"], eps)
        att, att_sx, wkv = self._time_mix(bp["time_mix"], h, att_sx, wkv)
        x = x + att
        h = L.rms_norm(x, bp["ln2"], eps)
        ffn, ffn_sx = self._channel_mix(bp["channel_mix"], h, ffn_sx)
        return x + ffn, (att_sx, ffn_sx, wkv)

    def _layers(self, params: Params, x, cache: Optional[Params] = None):
        """Run every block; returns ``x`` and the stacked per-layer states."""
        outs = []
        for i in range(self.cfg.n_layers):
            carry = (() if cache is None else
                     (cache["att_sx"][i], cache["ffn_sx"][i], cache["wkv"][i]))
            x, o = self._block(_layer(params["blocks"], i), x, *carry)
            outs.append(o)
        att_sx, ffn_sx, wkv = (torch.stack([o[j] for o in outs]) for j in range(3))
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x, {"att_sx": att_sx, "ffn_sx": ffn_sx, "wkv": wkv}

    # -- training-shape forward --------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Logits ``[B,S,V]`` and a zero aux loss."""
        x, _ = self._layers(params, params["embed"][tokens])
        return x @ params["lm_head"], torch.zeros((), device=x.device)

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, s_max: int = 0, dtype=None) -> Params:
        """State cache: O(1) in context length (``s_max`` unused)."""
        dt = dtype or self.dtype
        H, K = self.n_heads, self.head_dim
        n, d, dev = self.cfg.n_layers, self.cfg.d_model, self.device
        return {
            "att_sx": torch.zeros((n, batch, d), dtype=dt, device=dev),
            "ffn_sx": torch.zeros((n, batch, d), dtype=dt, device=dev),
            "wkv": torch.zeros((n, batch, H, K, K), dtype=torch.float32, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def prefill(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
        """Run the prompt; returns last-token logits ``[B,V]`` and the cache."""
        x, cache = self._layers(params, params["embed"][tokens])
        cache["pos"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                    device=x.device)
        return x[:, -1] @ params["lm_head"], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params
                    ) -> Tuple[torch.Tensor, Params]:
        """One token per sequence (``tokens [B]``) on the carried state."""
        x, new = self._layers(params, params["embed"][tokens][:, None, :], cache)
        new["pos"] = cache["pos"] + 1
        return (x @ params["lm_head"])[:, 0], new
