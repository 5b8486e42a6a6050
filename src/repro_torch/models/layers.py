"""Shared layers (the part of ``repro.models.layers`` the port's models use).

Parameters keep the reference's layout and names: attention ``wq
[D, H*hd]``, ``wk/wv [D, KV*hd]``, ``wo [H*hd, D]`` (+ ``bq/bk/bv`` with
``qkv_bias``); gated MLP ``w1`` (gate) and ``w3`` (up) ``[D, F]``, ``w2``
(down) ``[F, D]``.  A model declares its parameters as a *spec* — a tree
of ``name -> (shape, init)`` — and draws them with :func:`init_from_spec`;
the same spec is the schema :func:`repro_torch.convert.params_from_jax`
checks.  ``attention`` reads ``cfg.attention_impl``: ``"xla"`` is the
plain grouped attention, ``"flash"`` the flash kernel
(:func:`repro_torch.kernels.ops.attention_op`); ``kv_override`` makes it
cross-attention (Whisper's decoder), always on the plain path, as in the
reference; ``attention_decode`` is the single-token step against a KV
cache.  MoE and MLA come with their slice (ROADMAP.md §1).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

__all__ = [
    "apply_rope", "attention", "attention_decode", "attention_spec", "dense_init",
    "init_from_spec", "layer_norm", "make_rope", "map_spec", "mlp", "mlp_spec",
    "rms_norm", "unbind_layers",
]

Params = Dict[str, Any]

ZEROS, ONES = ("const", 0.0), ("const", 1.0)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, scale) weights drawn in f32 from ``generator``, then cast.

    ``scale`` defaults to ``1/sqrt(shape[0])`` (fan-in of an ``[in, out]``
    weight used as ``x @ w``).  The tensor lies on the generator's device.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def map_spec(spec: Any, fn: Callable[[Any], Any]) -> Any:
    """``fn`` applied to every ``(shape, init)`` entry of a spec tree
    (dicts, and lists such as the hybrid model's ``"tail"`` blocks)."""
    if isinstance(spec, dict):
        return {k: map_spec(v, fn) for k, v in spec.items()}
    if isinstance(spec, list):
        return [map_spec(v, fn) for v in spec]
    return fn(spec)


def init_from_spec(generator: torch.Generator, spec: Params,
                   dtype: torch.dtype) -> Params:
    """Draw a parameter tree from ``spec``, in the spec's key order.

    ``init`` is ``("normal", scale)`` — ``scale=None`` means
    ``1/sqrt(fan-in)``, the ``in`` of a (possibly layer-stacked)
    ``[..., in, out]`` weight — or ``("const", value)``.
    """
    def make(entry):
        shape, (kind, val) = entry
        if kind == "const":
            return torch.full(shape, val, dtype=dtype, device=generator.device)
        scale = shape[-2] ** -0.5 if val is None else val
        return dense_init(generator, shape, scale=scale, dtype=dtype)

    return map_spec(spec, make)


def unbind_layers(tree: Params, n: int) -> list:
    """The ``n`` layers of a stacked block tree, as views (``torch.unbind``).

    One unbind per leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would add a full-size zero tensor per
    layer.
    """
    def split(t):
        return {k: split(v) for k, v in t.items()} if isinstance(t, dict) \
            else torch.unbind(t)

    parts = split(tree)

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]

    return [pick(parts, i) for i in range(n)]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mixed-precision RMSNorm, as the reference computes it: the variance
    in f32, the scale cast to ``x.dtype``, then ``x * scale * w``."""
    var = x.float().square().mean(-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * w.to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (``layers.py:129-140``), cast back to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def make_rope(positions: torch.Tensor, dim: int, theta: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` [..., S] -> [..., S, dim/2]."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, H, S, hd]; cos/sin: [S, hd/2] or [B, S, hd/2] (half-split)."""
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (plain tensor ops, or the flash kernel through kernels/ops)
# ---------------------------------------------------------------------------

def attention_spec(cfg) -> Params:
    """Attention parameters of one layer: ``name -> (shape, init)``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": ((d, h * hd), ("normal", None)),
        "wk": ((d, kv * hd), ("normal", None)),
        "wv": ((d, kv * hd), ("normal", None)),
        "wo": ((h * hd, d), ("normal", None)),
    }
    if cfg.qkv_bias:
        p.update(bq=((h * hd,), ZEROS), bk=((kv * hd,), ZEROS),
                 bv=((kv * hd,), ZEROS))
    return p


def _qkv(p: Params, x: torch.Tensor, cfg):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, h, hd).transpose(1, 2)
    k = k.reshape(B, S, kv, hd).transpose(1, 2)
    v = v.reshape(B, S, kv, hd).transpose(1, 2)
    return q, k, v


def _sdpa(q, k, v, *, causal: bool, window: int = 0,
          q_positions=None, kv_positions=None, q_chunk: int = 0) -> torch.Tensor:
    """Grouped scaled-dot-product attention, f32 softmax (``layers.py:198-240``).

    q: [B, H, Sq, hd]; k/v: [B, KV, Sk, hd] with H % KV == 0; GQA by
    reshaping q to ``[B, KV, G, Sq, hd]``.  ``q_chunk`` > 0 evaluates the
    queries in chunks, each checkpointed, bounding the transient
    ``[.., q_chunk, Sk]`` scores in the forward and the backward pass.
    """
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    dev = q.device
    qp = q_positions if q_positions is not None else torch.arange(Sq, device=dev)
    kp = kv_positions if kv_positions is not None else \
        torch.arange(k.shape[2], device=dev)

    def block(q_blk, qp_blk):
        # q_blk: [B, KV, G, c, hd]
        scores = torch.einsum("bkgqd,bksd->bkgqs", q_blk, k).float()
        scores = scores / math.sqrt(hd)
        if causal or window:
            rel = qp_blk[:, None] - kp[None, :]
            mask = rel >= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
            if window:
                mask = mask & (rel < window)
            scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bkgqs,bksd->bkgqd", probs, v)

    qg = q.reshape(B, KV, G, Sq, hd)
    if q_chunk and Sq > 2 * q_chunk and Sq % q_chunk == 0:
        out = torch.cat([
            checkpoint(block, qg[:, :, :, i:i + q_chunk], qp[i:i + q_chunk],
                       use_reentrant=False)
            for i in range(0, Sq, q_chunk)], dim=3)
    else:
        out = block(qg, qp)
    return out.reshape(B, H, Sq, v.shape[-1])


def attention(
    p: Params,
    x: torch.Tensor,
    cfg,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    kv_override: Optional[Tuple[torch.Tensor, ...]] = None,
    use_rope: bool = True,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention.  Returns (out [B,S,D], kv for caching).

    ``kv_override = (src,)`` makes it cross-attention (``layers.py:243-268``):
    k/v are projected from ``src [B, Sk, D]``, no RoPE, no mask, and the
    plain grouped attention runs whatever ``attention_impl`` says (the
    flash kernel takes only Sq == Sk).
    """
    B, S, _ = x.shape
    if kv_override is not None:
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        src = kv_override[0]
        Sk = src.shape[1]
        q = (x @ p["wq"]).reshape(B, S, h, hd).transpose(1, 2)
        k = (src @ p["wk"]).reshape(B, Sk, kv, hd).transpose(1, 2)
        v = (src @ p["wv"]).reshape(B, Sk, kv, hd).transpose(1, 2)
        out = _sdpa(q, k, v, causal=False, q_chunk=cfg.attn_q_chunk)
        out = out.transpose(1, 2).reshape(B, S, h * hd)
        return out @ p["wo"], {"k": k, "v": v}
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg)
    if use_rope:
        cos, sin = make_rope(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cfg.attention_impl == "flash":
        out = _flash(q, k, v, causal=causal, window=window)
    else:
        out = _sdpa(q, k, v, causal=causal, window=window,
                    q_positions=positions, kv_positions=positions,
                    q_chunk=cfg.attn_q_chunk)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"], {"k": k, "v": v}


def _flash(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    """The flash kernel on the roped q/k and v, positions ``0..S-1``.

    The kernel has no backward, so with grad enabled this raises rather
    than fall back.  The plain version's key blocks are the largest
    divisor of S up to 128, so every prompt length passes the reference's
    ``S % block`` check; the CUDA kernel tiles on its own.
    """
    if torch.is_grad_enabled():
        raise NotImplementedError(
            "attention_impl='flash' is forward-only (no backward kernel yet, "
            "ROADMAP.md §2, row 3): run it under torch.no_grad() or "
            "torch.inference_mode(), or train with attention_impl='xla'")
    block = math.gcd(q.shape[2], 128)
    return ops.attention_op(q, k, v, causal=causal, window=window,
                            block_q=block, block_k=block)


def attention_decode(
    p: Params,
    x: torch.Tensor,                  # [B, 1, D]
    cache: Dict[str, torch.Tensor],   # k/v: [B, KV, S_max, hd]
    pos: torch.Tensor,                # 0-dim int: the write index
    cfg,
    *,
    window: int = 0,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode against the KV cache (``layers.py:290-329``).

    The new k/v are written into ``cache["k"]``/``cache["v"]`` at ``pos``
    in place (the reference's ``dynamic_update_slice`` returns new
    buffers); the returned dict holds the same tensors.  ``pos`` stays on
    the device, so the step never waits on the host.
    """
    B = x.shape[0]
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    q, k_new, v_new = _qkv(p, x, cfg)
    if use_rope:
        cos, sin = make_rope(pos[None], hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    k, v = cache["k"], cache["v"]
    at = pos.reshape(1).long()
    k.index_copy_(2, at, k_new.to(k.dtype))
    v.index_copy_(2, at, v_new.to(v.dtype))
    kp = torch.arange(k.shape[2], device=k.device)
    valid = kp <= pos
    if window:
        valid = valid & (kp > pos - window)
    qh = q.reshape(B, KV, cfg.n_heads // KV, 1, hd)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qh, k).float() / math.sqrt(hd)
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v)
    out = out.reshape(B, 1, cfg.n_heads * hd)
    return out @ p["wo"], {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_spec(d: int, f: int) -> Params:
    """Gated-MLP parameters of one layer: ``name -> (shape, init)``."""
    return {"w1": ((d, f), ("normal", None)),
            "w3": ((d, f), ("normal", None)),
            "w2": ((f, d), ("normal", None))}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
