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
cache.  MoE (``layers.py:345-470``): experts carry a leading ``E`` dim,
the router stays f32 in any model dtype; ``moe_layer`` picks the GShard
one-hot dispatch (``moe_dense``), the sorted scatter (``moe_scatter``) or,
under an armed EP mesh, :func:`repro_torch.parallel.moe_a2a.moe_a2a`.
MLA (deepseek-v2's latent attention, ``layers.py:477-674``) caches the
compressed ``ckv``/``k_rope`` and decodes naive or matrix-absorbed;
``attention_tp``, ``mla_attention_tp`` and ``mlp_tp`` run over a model
axis.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import P
from repro_torch.parallel.tensor import model_dim, tp_linear

__all__ = [
    "clear_sequence_parallel", "set_sequence_parallel", "sp_constrain",
    "sp_gather_kv", "sp_head_constrain", "sp_shard_heads",
    "apply_rope", "attention", "attention_decode", "attention_spec",
    "attention_tp", "dense_init", "init_from_spec", "layer_norm", "make_rope",
    "map_spec", "mla_attention", "mla_attention_decode",
    "mla_attention_decode_absorbed", "mla_attention_tp", "mla_spec", "mlp",
    "mlp_spec", "mlp_tp",
    "moe_dense", "moe_dense_ranks", "moe_layer", "moe_scatter", "moe_spec",
    "rms_norm", "stack_spec", "unbind_layers",
]

Params = Dict[str, Any]

ZEROS, ONES = ("const", 0.0), ("const", 1.0)


# ---------------------------------------------------------------------------
# sequence parallelism (SP), layers.py:43-99
# ---------------------------------------------------------------------------
# The reference pins layouts with ``with_sharding_constraint``, which is
# the identity in value; the launcher arms the mesh context
# (``launch.specs.configure_sp``) and, unarmed, every call is a no-op.  The
# port keeps the guards and the call sites, returns its input, and records
# the layout each function asked for last (``_SP_STATE["asked"]``).  The
# S-sharded form of SP (a reduce-scatter and an all-gather in place of the
# model axis's all-reduce) is ROADMAP.md §1's performance work.

_SP_STATE: Dict[str, Any] = {"dp": None, "tp": None, "tp_size": 1, "asked": {}}


def set_sequence_parallel(dp_axes, tp_axis, tp_size) -> None:
    _SP_STATE.update(dp=tuple(dp_axes) if dp_axes else None,
                     tp=tp_axis, tp_size=tp_size)


def clear_sequence_parallel() -> None:
    _SP_STATE.update(dp=None, tp=None, tp_size=1, asked={})


def _ask(fn: str, x: torch.Tensor, *parts) -> torch.Tensor:
    _SP_STATE["asked"][fn] = P(*parts)
    return x


def sp_constrain(x: torch.Tensor) -> torch.Tensor:
    """Ask for [B, S, D] activations on (dp, model, None)."""
    tp = _SP_STATE["tp"]
    if tp is None or x.dim() != 3 or x.shape[1] % max(_SP_STATE["tp_size"], 1):
        return x
    return _ask("sp_constrain", x, _SP_STATE["dp"] or (), tp, None)


def sp_shard_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Ask for [B, H, S, d] tensors head-sharded over the model axis."""
    tp = _SP_STATE["tp"]
    if tp is None or t.dim() != 4 or n_heads % max(_SP_STATE["tp_size"], 1):
        return t
    return _ask("sp_shard_heads", t, _SP_STATE["dp"] or (), tp, None, None)


def sp_head_constrain(head: torch.Tensor) -> torch.Tensor:
    """Ask for the [D, V] unembedding vocab-sharded over the model axis."""
    tp = _SP_STATE["tp"]
    if tp is None or head.dim() != 2 or \
            head.shape[1] % max(_SP_STATE["tp_size"], 1):
        return head
    return _ask("sp_head_constrain", head, None, tp)


def sp_gather_kv(k: torch.Tensor, cfg) -> torch.Tensor:
    """Ask for [B, KV, S, hd] K/V gathered over S, head-sharded."""
    tp = _SP_STATE["tp"]
    if tp is None or k.dim() != 4:
        return k
    heads = tp if k.shape[1] % max(_SP_STATE["tp_size"], 1) == 0 else None
    return _ask("sp_gather_kv", k, _SP_STATE["dp"] or (), heads, None, None)


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


def stack_spec(spec: Any, n: int) -> Any:
    """``spec`` with a leading layer dimension of ``n`` on every entry."""
    return map_spec(spec, lambda e: ((n, *e[0]), *e[1:]))


def init_from_spec(generator: torch.Generator, spec: Params,
                   dtype: torch.dtype) -> Params:
    """Draw a parameter tree from ``spec``, in the spec's key order.

    An entry is ``(shape, init)`` or ``(shape, init, leaf_dtype)``; the
    leaf is in ``leaf_dtype`` if given (the MoE router stays f32 in a bf16
    model), else in ``dtype``.  ``init`` is ``("normal", scale)`` —
    ``scale=None`` means ``1/sqrt(fan-in)``, the ``in`` of a (possibly
    layer-stacked) ``[..., in, out]`` weight — or ``("const", value)``.
    """
    def make(entry):
        shape, (kind, val) = entry[:2]
        dt = entry[2] if len(entry) > 2 else dtype
        if kind == "const":
            return torch.full(shape, val, dtype=dt, device=generator.device)
        scale = shape[-2] ** -0.5 if val is None else val
        return dense_init(generator, shape, scale=scale, dtype=dt)

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
        if cfg.attn_q_chunk and getattr(cfg, "hoist_kv_gather", True):
            k = sp_gather_kv(k, cfg)
            v = sp_gather_kv(v, cfg)
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


# ---------------------------------------------------------------------------
# tensor parallelism: the dense family's layers over a model axis
# ---------------------------------------------------------------------------

def mlp_tp(p: Params, spec: Params, x: torch.Tensor, tp) -> torch.Tensor:
    """The gated MLP over ``tp``'s model axis: ``w1``/``w3``
    column-parallel, ``w2`` row-parallel and all-reduced; whole on every
    rank where the spec leaves ``w1`` replicated."""
    if model_dim(spec["w1"]) is None:
        return mlp(p, x)
    xm = tp.scatter(x)
    h = F.silu(tp_linear(xm, p["w1"])) * tp_linear(xm, p["w3"])
    return tp.reduce(tp_linear(h, p["w2"]))


def attention_tp(p: Params, spec: Params, x: torch.Tensor, cfg, tp, *,
                 positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Causal self-attention over ``tp``'s model axis: ``[B, S, D]`` in
    and out.

    ``wq``/``bq`` (and ``wk``/``wv``/``bk``/``bv`` where the KV heads
    divide) are column-parallel: model rank ``j`` computes query heads
    ``j*H/m .. (j+1)*H/m - 1``; ``wo`` is row-parallel and all-reduced.
    Where the query heads divide and the KV heads do not, k and v are
    computed whole, once, and each rank reads the KV head each of its
    query heads maps to (``i // (H/KV)``).  Where the query heads do not
    divide, the attention is whole on every rank, with no collective.
    """
    if model_dim(spec["wq"]) is None:
        return attention(p, x, cfg, causal=True, positions=positions,
                         window=window)[0]
    B, S, _ = x.shape
    m, hd, kv = tp.m, cfg.head_dim, cfg.n_kv_heads
    hl = cfg.n_heads // m
    cos, sin = make_rope(positions, hd, cfg.rope_theta)
    xm = tp.scatter(x)

    def heads(t, n):               # [m, B, S, n*hd] -> [m*B, n, S, hd]
        return t.reshape(m * B, S, n, hd).transpose(1, 2)

    def proj(name):
        t = tp_linear(xm, p[name])
        return t + p["b" + name[1]][:, None, None] if cfg.qkv_bias else t

    q = apply_rope(heads(proj("wq"), hl), cos, sin)
    if model_dim(spec["wk"]) is not None:
        k = apply_rope(heads(proj("wk"), kv // m), cos, sin)
        v = heads(proj("wv"), kv // m)
    else:
        k, v = (x @ p["wk"], x @ p["wv"])
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
        k = apply_rope(k.reshape(B, S, kv, hd).transpose(1, 2), cos, sin)
        v = v.reshape(B, S, kv, hd).transpose(1, 2)
        dev = x.device
        rank = torch.arange(m, device=dev)[:, None]
        pick = (rank * hl + torch.arange(hl, device=dev)) // (cfg.n_heads // kv)
        # [m, hl, B, S, hd]: rank j's copy, at the KV head of each query head
        k = tp.scatter(k)[rank, :, pick].transpose(1, 2).reshape(m * B, hl, S, hd)
        v = tp.scatter(v)[rank, :, pick].transpose(1, 2).reshape(m * B, hl, S, hd)
    if cfg.attention_impl == "flash":
        out = _flash(q, k, v, causal=True, window=window)
    else:
        out = _sdpa(q, k, v, causal=True, window=window, q_positions=positions,
                    kv_positions=positions, q_chunk=cfg.attn_q_chunk)
    out = out.transpose(1, 2).reshape(m, B, S, hl * hd)
    return tp.reduce(tp_linear(out, p["wo"]))


# ---------------------------------------------------------------------------
# MoE (layers.py:345-470)
# ---------------------------------------------------------------------------

def moe_spec(cfg) -> Params:
    """MoE parameters of one layer: the f32 router, the ``E`` experts'
    gated MLPs ``[E, d, fe]``/``[E, fe, d]`` and the fused shared experts.

    The reference draws the expert weights with ``dense_init``'s default,
    ``1/sqrt(shape[0])``: ``1/sqrt(E)``, not the fan-in, so it is stated.
    """
    d, fe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    s = E ** -0.5
    p = {"router": ((d, E), ("normal", 0.02), torch.float32),
         "w1": ((E, d, fe), ("normal", s)),
         "w3": ((E, d, fe), ("normal", s)),
         "w2": ((E, fe, d), ("normal", s))}
    if cfg.n_shared_experts:
        p["shared"] = mlp_spec(d, fe * cfg.n_shared_experts)
    return p


def _router_stats(p: Params, x: torch.Tensor, cfg):
    """Top-k gating in f32: ``(expert_idx [.., K], weights [.., K], p_e,
    f_e)``: the weights the top-k probabilities renormalised, ``p_e`` each
    expert's mean probability and ``f_e`` the share of tokens that chose
    it (no gradient: it counts)."""
    E = cfg.n_experts
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    lead = tuple(range(probs.dim() - 1))
    me = probs.mean(dim=lead)
    ce = (F.one_hot(idx, E).sum(-2) > 0).float().mean(dim=lead)
    return idx, weights, me, ce


def _router_probs(p: Params, x: torch.Tensor, cfg):
    """Top-k gating in f32: ``(expert_idx [.., K], weights [.., K], aux)``,
    ``aux`` the Switch-style load-balancing loss ``E * sum_e f_e * p_e``."""
    idx, weights, me, ce = _router_stats(p, x, cfg)
    return idx, weights, cfg.n_experts * torch.sum(me * ce)


def _experts(p: Params, xin: torch.Tensor, lead: str) -> torch.Tensor:
    """The experts' gated MLPs on their slots ``xin [.., E, C, D]``."""
    h = F.silu(torch.einsum(f"{lead}ecd,edf->{lead}ecf", xin, p["w1"]))
    h = h * torch.einsum(f"{lead}ecd,edf->{lead}ecf", xin, p["w3"])
    return torch.einsum(f"{lead}ecf,efd->{lead}ecd", h, p["w2"])


def moe_dense(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard one-hot dispatch with capacity (``layers.py:382-421``).

    x ``[B, S, D]`` in groups of ``moe_group_size`` tokens along S; each
    (token, k) choice takes the next slot of its expert's queue (f32
    cumsum positions, exact for these counts), and a choice past the
    capacity ``C = max(ceil(g*K/E*cf), K)`` is dropped.
    """
    xg = _dispatch_groups(x, cfg)
    idx, w, aux = _router_probs(p, xg, cfg)                  # [G, g, K]
    return _dense_dispatch(p, x, xg, idx, w, cfg), aux


def _dispatch_groups(x: torch.Tensor, cfg) -> torch.Tensor:
    """``x [B, S, D]`` as ``[B * n_g, g, D]``, ``g = min(moe_group_size, S)``."""
    B, S, D = x.shape
    group = min(cfg.moe_group_size, S)
    return x.reshape(B * max(S // group, 1), group, D)


def _dense_dispatch(p: Params, x: torch.Tensor, xg: torch.Tensor,
                    idx: torch.Tensor, w: torch.Tensor, cfg) -> torch.Tensor:
    """:func:`moe_dense`'s output for the routing ``idx``/``w`` of the
    groups ``xg``."""
    E = cfg.n_experts
    G, group, K = idx.shape
    C = max(int(math.ceil(group * K / E * cfg.capacity_factor)), K)
    onehot = F.one_hot(idx, E).float()                      # [G, g, K, E]
    pos_e = torch.cumsum(onehot.reshape(G, -1, E), dim=1).reshape(
        G, group, K, E) - onehot
    pos = torch.einsum("gtke,gtke->gtk", pos_e, onehot).to(torch.int64)
    # masks in the activation dtype, as the reference keeps them
    keep = (pos < C).to(x.dtype)[..., None] * onehot.to(x.dtype)
    # one_hot of a position past C is all zeros, as jax.nn.one_hot's
    posc = (pos[..., None] == torch.arange(C, device=x.device)).to(x.dtype)
    dispatch = torch.einsum("gtke,gtkc->gtec", keep, posc)  # [G, g, E, C]
    combine = torch.einsum("gtk,gtke,gtkc->gtec", w.to(x.dtype), keep, posc)
    xin = torch.einsum("gtec,gtd->gecd", dispatch, xg)       # [G, E, C, D]
    xout = _experts(p, xin, "g")
    y = torch.einsum("gtec,gecd->gtd", combine, xout).reshape(x.shape)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x)
    return y


def moe_dense_ranks(ps: Sequence[Params], xs: Sequence[torch.Tensor], cfg,
                    tp=None) -> Tuple[list, torch.Tensor]:
    """:func:`moe_dense` on each data rank's rows, rank ``r`` reading its
    own view ``ps[r]`` of the layer (model-axis storage under ``tp``, the
    experts gathered whole as :func:`moe_layer` gathers them), with the
    aux loss of the whole batch: the reference's ``moe_dense`` where EP
    cannot arm runs on the global batch, so ``f_e`` is every rank's
    tokens' share.  The ranks' shares are averaged (the data axis's
    all-reduce of the counts; every rank routes as many tokens), each
    rank's ``E * sum_e f_e * p_e`` takes its own ``p_e``, and their mean
    is the global aux, each rank's gradient its rows' part of it.
    Dispatch and capacity are per group of a row, so a rank's outputs
    are the global batch's rows."""
    from repro_torch.parallel.moe_a2a import whole_weights

    if tp is not None:
        ps = [whole_weights(p, tp) for p in ps]
    xgs = [_dispatch_groups(x, cfg) for x in xs]
    stats = [_router_stats(p, xg, cfg) for p, xg in zip(ps, xgs)]
    ce = torch.stack([s[3] for s in stats]).mean(0)
    ys = [_dense_dispatch(p, x, xg, idx, w, cfg)
          for p, x, xg, (idx, w, _, _) in zip(ps, xs, xgs, stats)]
    aux = torch.stack([cfg.n_experts * torch.sum(me * ce)
                       for _, _, me, _ in stats]).mean()
    return ys, aux


def _pack(dest: torch.Tensor, n: int, cap: int):
    """Capacity-bounded slots for the choices ``dest [TK]`` in ``n``
    queues of ``cap``: a stable argsort by queue, each choice's position
    in its queue, ``keep`` for those under ``cap`` and their ``slot``s,
    all in the sorted order ``order``."""
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    seg = torch.searchsorted(sorted_dest, torch.arange(n, device=dest.device))
    pos = torch.arange(dest.numel(), device=dest.device) - seg[sorted_dest]
    keep = pos < cap
    return order, keep, sorted_dest * cap + torch.where(keep, pos, 0)


def moe_scatter(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch (``layers.py:424-458``): a stable argsort of the
    choices by expert, capacity ``max(ceil(T*K/E*cf), K)`` over all
    ``T = B*S`` tokens; the reference's ``.at[].add`` is ``index_add_``
    (duplicate slots add)."""
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    xf = x.reshape(T, D)
    idx, w, aux = _router_probs(p, xf, cfg)                  # [T, K]
    K = idx.shape[-1]
    C = max(int(math.ceil(T * K / E * cfg.capacity_factor)), K)
    order, keep, slot = _pack(idx.reshape(-1), E, C)
    tok = order // K
    buf = xf.new_zeros((E * C, D)).index_add(
        0, slot, torch.where(keep[:, None], xf[tok], 0))
    xout = _experts(p, buf.reshape(E, C, D), "").reshape(E * C, D)
    gathered = torch.where(keep[:, None], xout[slot], 0)
    contrib = gathered * w.reshape(-1)[order][:, None]
    # the reference scatters into an x.dtype buffer: the f32 products are
    # cast to it first
    y = xf.new_zeros((T, D)).index_add(0, tok, contrib.to(x.dtype))
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x)
    return y, aux


def moe_layer(p: Params, x: torch.Tensor, cfg, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dispatch rules (``layers.py:461-474``): ``a2a`` on a
    prompt runs :func:`~repro_torch.parallel.moe_a2a.moe_a2a` under an
    armed EP mesh, with grad enabled too, and ``moe_dense`` without one; a
    decode step (S == 1) takes ``moe_scatter`` under ``moe_impl="scatter"``,
    else ``moe_dense`` (one token a sequence keeps the experts' weights
    resident).  Given ``tp`` (a
    :class:`~repro_torch.parallel.tensor.TensorParallel`), ``p`` is the
    layer's model-axis storage: the EP path gathers the experts over the
    model axis, the dense dispatch takes them gathered whole."""
    from repro_torch.parallel.moe_a2a import ep_armed, moe_a2a, whole_weights

    if cfg.moe_impl == "a2a" and x.shape[1] > 1 and ep_armed(cfg):
        return moe_a2a(p, x, cfg) if tp is None else moe_a2a(p, x, cfg, tp)
    if tp is not None:
        p = whole_weights(p, tp)
    if cfg.moe_impl == "scatter":
        return moe_scatter(p, x, cfg)
    return moe_dense(p, x, cfg)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2 multi-head latent attention, layers.py:477-674)
# ---------------------------------------------------------------------------

def mla_spec(cfg) -> Params:
    """MLA parameters of one layer: the q and kv low-rank paths, their
    norms, the shared-head rope key and the output projection."""
    d, h = cfg.d_model, cfg.n_heads
    qk, qr, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": ((d, cfg.q_lora_rank), ("normal", None)),
        "q_norm": ((cfg.q_lora_rank,), ONES),
        "wq_b": ((cfg.q_lora_rank, h * (qk + qr)), ("normal", None)),
        "wkv_a": ((d, cfg.kv_lora_rank), ("normal", None)),
        "kv_norm": ((cfg.kv_lora_rank,), ONES),
        "wk_rope": ((d, qr), ("normal", None)),
        "wkv_b": ((cfg.kv_lora_rank, h * (qk + vh)), ("normal", None)),
        "wo": ((h * vh, d), ("normal", None)),
    }


def _mla_q(p: Params, x: torch.Tensor, cos, sin, cfg):
    """The roped query halves ``(q_nope [B,H,S,qk], q_rope [B,H,S,qr])``."""
    B, S, _ = x.shape
    qk, qr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(B, S, cfg.n_heads, qk + qr).transpose(1, 2)
    return q[..., :qk], apply_rope(q[..., qk:], cos, sin)


def _mla_latent(p: Params, x: torch.Tensor, cos, sin, cfg):
    """The cached latents: ``ckv [B,S,r_kv]`` and the roped, shared-head
    ``k_rope [B,S,qr]``."""
    B, S, _ = x.shape
    qr = cfg.qk_rope_head_dim
    ckv = rms_norm(x @ p["wkv_a"], p["kv_norm"], cfg.norm_eps)
    k_rope = (x @ p["wk_rope"]).reshape(B, S, 1, qr).transpose(1, 2)
    return ckv, apply_rope(k_rope, cos, sin).squeeze(1)


def _mla_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg):
    """``(q_nope, q_rope, k_nope, k_rope, v, ckv)`` (``layers.py:495-530``):
    per-head k/v from the latent, the rope key shared by every head."""
    B, S, _ = x.shape
    qk, vh = cfg.qk_nope_head_dim, cfg.v_head_dim
    cos, sin = make_rope(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope = _mla_q(p, x, cos, sin, cfg)
    ckv, k_rope = _mla_latent(p, x, cos, sin, cfg)
    kv = (ckv @ p["wkv_b"]).reshape(B, S, cfg.n_heads, qk + vh).transpose(1, 2)
    h = cfg.n_heads
    return (sp_shard_heads(q_nope, h), sp_shard_heads(q_rope, h),
            sp_shard_heads(kv[..., :qk], h), k_rope,
            sp_shard_heads(kv[..., qk:], h), ckv)


def _mla_sdpa(q_nope, q_rope, k_nope, k_rope, v, *, q_positions,
              kv_positions, sm_scale: float, q_chunk: int = 0) -> torch.Tensor:
    """Two-term MLA attention (``layers.py:533-556``): scores are the sum
    of the nope and the shared rope products, accumulated in f32 (the
    reference's ``preferred_element_type``), then the causal mask and an
    f32 softmax; ``q_chunk`` evaluates the queries in checkpointed chunks
    when ``Sq > 2 * q_chunk`` and divides it."""
    B, H, Sq, _ = q_nope.shape
    kn, kr = k_nope.float(), k_rope.float()

    def block(qn, qr_, qp):
        s = (torch.einsum("bhqd,bhsd->bhqs", qn.float(), kn)
             + torch.einsum("bhqd,bsd->bhqs", qr_.float(), kr)) * sm_scale
        rel = qp[:, None] - kv_positions[None, :]
        s = torch.where(rel >= 0, s, -1e30)
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bhqs,bhsd->bhqd", probs, v)

    if q_chunk and Sq > 2 * q_chunk and Sq % q_chunk == 0:
        return torch.cat([
            checkpoint(block, q_nope[:, :, i:i + q_chunk],
                       q_rope[:, :, i:i + q_chunk], q_positions[i:i + q_chunk],
                       use_reentrant=False)
            for i in range(0, Sq, q_chunk)], dim=2)
    return block(q_nope, q_rope, q_positions)


def mla_attention(p: Params, x: torch.Tensor, cfg,
                  positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training/prefill MLA: ``(out [B,S,D], {"ckv", "k_rope"})``, the
    cache the compressed latents."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q_nope, q_rope, k_nope, k_rope, v, ckv = _mla_qkv(p, x, positions, cfg)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    out = _mla_sdpa(q_nope, q_rope, k_nope, k_rope, v, q_positions=positions,
                    kv_positions=positions, sm_scale=scale,
                    q_chunk=cfg.attn_q_chunk)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.v_head_dim)
    return out @ p["wo"], {"ckv": ckv, "k_rope": k_rope}


def mla_attention_tp(p: Params, spec: Params, x: torch.Tensor, cfg, tp, *,
                     positions: torch.Tensor) -> torch.Tensor:
    """Training MLA over ``tp``'s model axis: ``[B, S, D]`` in and out,
    by the reference's rules (``repro/parallel/sharding.py:89-110``).

    The down-projections ``wq_a``/``wkv_a``/``wk_rope`` and both norms are
    replicated: the latents ``cq``, ``ckv`` and the roped ``k_rope`` are
    computed once and reach every rank through the conjugate identity, so
    their gradients (and through them the down-projections' and the
    norms') are summed over the model ranks once.  ``wq_b``/``wkv_b`` are
    column-parallel by heads: model rank ``j`` computes heads ``j*H/m ..
    (j+1)*H/m - 1`` from the latents, with the two-term softmax of
    :func:`_mla_sdpa`; ``wo`` is row-parallel and all-reduced.  Where the
    heads do not divide, the attention is whole on every rank, with no
    collective."""
    if model_dim(spec["wq_b"]) is None:
        return mla_attention(p, x, cfg, positions)[0]
    B, S, _ = x.shape
    m = tp.m
    hl = cfg.n_heads // m
    qk, qr, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    cos, sin = make_rope(positions, qr, cfg.rope_theta)
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    ckv, k_rope = _mla_latent(p, x, cos, sin, cfg)
    q = tp_linear(tp.scatter(cq), p["wq_b"])           # [m, B, S, hl*(qk+qr)]
    q = q.reshape(m * B, S, hl, qk + qr).transpose(1, 2)
    kv = tp_linear(tp.scatter(ckv), p["wkv_b"])        # [m, B, S, hl*(qk+vh)]
    kv = kv.reshape(m * B, S, hl, qk + vh).transpose(1, 2)
    out = _mla_sdpa(q[..., :qk], apply_rope(q[..., qk:], cos, sin),
                    kv[..., :qk], tp.scatter(k_rope).reshape(m * B, S, qr),
                    kv[..., qk:], q_positions=positions,
                    kv_positions=positions, sm_scale=1.0 / math.sqrt(qk + qr),
                    q_chunk=cfg.attn_q_chunk)
    out = out.transpose(1, 2).reshape(m, B, S, hl * vh)
    return tp.reduce(tp_linear(out, p["wo"]))


def _mla_decode_start(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                      pos: torch.Tensor, cfg):
    """The step's roped query halves, with its latents written into
    ``cache["ckv"]``/``cache["k_rope"]`` at ``pos`` in place; and the
    ``[S_max]`` mask of the positions written so far."""
    cos, sin = make_rope(pos[None], cfg.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope = _mla_q(p, x, cos, sin, cfg)
    ckv_new, kr_new = _mla_latent(p, x, cos, sin, cfg)
    ckv, k_rope = cache["ckv"], cache["k_rope"]
    at = pos.reshape(1).long()
    ckv.index_copy_(1, at, ckv_new.to(ckv.dtype))
    k_rope.index_copy_(1, at, kr_new.to(k_rope.dtype))
    valid = torch.arange(ckv.shape[1], device=ckv.device) <= pos
    return q_nope, q_rope, ckv, k_rope, valid


def mla_attention_decode_absorbed(
        p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
        pos: torch.Tensor, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Matrix-absorbed MLA decode (``layers.py:582-637``): ``wkv_b`` folded
    into the query and output paths, so the step works in the rank-r_kv
    latent space and builds no ``[B, H, S, .]`` tensor.  The latents are
    written into the cache in place; the returned dict holds the same
    tensors."""
    B = x.shape[0]
    h, r_kv = cfg.n_heads, cfg.kv_lora_rank
    qk, qr, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, ckv, k_rope, valid = _mla_decode_start(p, x, cache, pos, cfg)
    wkv_b = p["wkv_b"].reshape(r_kv, h, qk + vh)
    w_uk, w_uv = wkv_b[..., :qk], wkv_b[..., qk:]
    q_lat = torch.einsum("bhqd,rhd->bhqr", q_nope, w_uk)       # [B,H,1,r_kv]
    # operands in the model dtype, products accumulated in f32
    scores = (torch.einsum("bhqr,bsr->bhqs", q_lat.float(), ckv.float())
              + torch.einsum("bhqd,bsd->bhqs", q_rope.float(), k_rope.float())
              ) / math.sqrt(qk + qr)
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    ctx = torch.einsum("bhqs,bsr->bhqr", probs, ckv)            # [B,H,1,r_kv]
    out = torch.einsum("bhqr,rhd->bhqd", ctx, w_uv)             # [B,H,1,vh]
    out = out.transpose(1, 2).reshape(B, 1, h * vh)
    return out @ p["wo"], {"ckv": ckv, "k_rope": k_rope}


def mla_attention_decode(
        p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
        pos: torch.Tensor, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode against the compressed cache ``ckv [B,S_max,r_kv]``,
    ``k_rope [B,S_max,qr]`` (``layers.py:640-674``): per-head k/v
    re-expanded from the latent (the naive decode), or, with
    ``cfg.mla_absorb``, :func:`mla_attention_decode_absorbed`."""
    if cfg.mla_absorb:
        return mla_attention_decode_absorbed(p, x, cache, pos, cfg)
    B = x.shape[0]
    h = cfg.n_heads
    qk, qr, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, ckv, k_rope, valid = _mla_decode_start(p, x, cache, pos, cfg)
    S_max = ckv.shape[1]
    kv = (ckv @ p["wkv_b"]).reshape(B, S_max, h, qk + vh).transpose(1, 2)
    k_nope, v = kv[..., :qk], kv[..., qk:]
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, None].expand(B, h, S_max, qr)], dim=-1)
    scores = torch.einsum("bhqd,bhsd->bhqs", q_full, k_full).float()
    scores = torch.where(valid, scores / math.sqrt(qk + qr), -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bhsd->bhqd", probs, v)
    out = out.transpose(1, 2).reshape(B, 1, h * vh)
    return out @ p["wo"], {"ckv": ckv, "k_rope": k_rope}
