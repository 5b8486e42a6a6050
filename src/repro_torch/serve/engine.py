"""Batched generation engine: prefill + decode with state caches.

Counterpart of ``repro.serve.engine``.  Wave-based batching: requests with
equal prompt length join a prefill wave; decode then steps the whole wave
until every slot finishes (EOS or the token budget).  PyTorch runs
eagerly, so the model's ``prefill`` and ``decode_step`` are called as they
are (the reference ``jax.jit``s them).

It serves the RWKV6 (``Rwkv6LM``, state caches) and dense (``DecoderLM``,
KV caches grown by :func:`_grow_cache` to the wave's decode headroom)
families.  Serving without a collective plan, as ``repro serve --reorder
none`` does on one device; the reference engine's ``plan=``/``session=``
members and ``arm_overlap`` are queued in ROADMAP.md §1 (slice 6, item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs

__all__ = ["GenerationConfig", "GenerationEngine", "make_serve_step"]


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    eos_token: int = 0
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0


def make_serve_step(model) -> Callable:
    """The single-token decode step."""

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)

    return serve_step


class GenerationEngine:
    def __init__(self, model, params, gen_cfg: Optional[GenerationConfig] = None):
        self.model = model
        self.params = params
        self.cfg = gen_cfg or GenerationConfig()
        self.device = model.device
        self.stats: Dict[str, float] = {"prefill_tokens": 0, "decode_steps": 0}

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = F.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.inference_mode()
    def generate(self, prompts: List[List[int]],
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        """One wave: equal-length prompts -> generated continuations."""
        lens = {len(p) for p in prompts}
        if len(lens) != 1:
            raise ValueError(f"a wave needs equal prompt lengths, got {lens}")
        max_new = max_new_tokens or self.cfg.max_new_tokens
        eos = self.cfg.eos_token
        tokens = torch.tensor(prompts, dtype=torch.long, device=self.device)
        B, P = tokens.shape

        with obs.tracer().span("serve.prefill", batch=B, prompt_len=P):
            logits, cache = self.model.prefill(self.params, tokens)
        self.stats["prefill_tokens"] += B * P
        cache = _grow_cache(cache, P, P + max_new)

        # TP decode issues an all-gather + reduce-scatter of the step's
        # activations per layer; the per-step logits block is the
        # observable proxy for that payload on a single device
        act_bytes = float(logits.numel() * logits.element_size())
        rec = obs.recorder()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed)
        out = np.zeros((B, max_new), dtype=np.int64)
        finished = np.zeros(B, dtype=bool)
        cur = self._sample(logits, gen)
        timer = obs.tracer().timer("serve.decode", batch=B)
        with timer:
            for t in range(max_new):
                cur_np = cur.cpu().numpy()
                out[:, t] = np.where(finished, eos, cur_np)
                finished |= cur_np == eos
                if finished.all():
                    break
                logits, cache = self.model.decode_step(self.params, cur, cache)
                self.stats["decode_steps"] += 1
                rec.record("all-gather", act_bytes)
                rec.record("reduce-scatter", act_bytes)
                cur = self._sample(logits, gen)
            timer.set(steps=t + 1)
        obs.metrics().counter("serve.waves").inc()
        return [row[: _trim(row, eos)].tolist() for row in out]


def _trim(row: np.ndarray, eos: int) -> int:
    hits = np.nonzero(row == eos)[0]
    return int(hits[0]) if len(hits) else len(row)


#: cache keys that carry a sequence dimension, and where it sits
#: (negative index).  State caches (wkv, *_sx) never grow.
_SEQ_DIM = {"k": -2, "v": -2, "ckv": -2, "k_rope": -2}


def _grow_cache(cache: Any, cur_len: int, new_len: int) -> Any:
    """Pad the sequence dim of prefill caches to decode headroom.

    Key-aware: only KV/latent buffers grow; recurrent states pass through.
    """
    if new_len <= cur_len:
        return cache

    def grow(name, leaf):
        if isinstance(leaf, dict):
            return {k: grow(k, v) for k, v in leaf.items()}
        if name not in _SEQ_DIM or not torch.is_tensor(leaf) or leaf.dim() == 0:
            return leaf
        d = leaf.dim() + _SEQ_DIM[name]
        if leaf.shape[d] != cur_len:   # ring buffer or fixed context
            return leaf
        pad = [0, 0] * (leaf.dim() - 1 - d) + [0, new_len - cur_len]
        return F.pad(leaf, pad)

    return {k: grow(k, v) for k, v in cache.items()}
