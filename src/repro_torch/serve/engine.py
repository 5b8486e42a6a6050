"""Batched generation engine: prefill + decode with state caches.

Counterpart of ``repro.serve.engine``.  Wave-based batching: requests with
equal prompt length join a prefill wave; decode then steps the whole wave
until every slot finishes (EOS or the token budget).  PyTorch runs
eagerly, so the model's ``prefill`` and ``decode_step`` are called as they
are (the reference ``jax.jit``s them).

It serves every family the port has: RWKV6 (``Rwkv6LM``, state caches),
dense and VLM (``DecoderLM``, KV caches grown by :func:`_grow_cache` to
the wave's decode headroom), the hybrid (``RecurrentGemmaLM``, whose own
``grow_cache`` keeps its ring-buffer window caches as they are) and
Whisper (``WhisperLM``: self-attention k/v grown, cross-attention
``xk``/``xv`` fixed at the audio context); the VLM and Whisper take their
front end's embeddings as ``frontend_embeds``.
As the reference's engine, it takes a compiled collective plan
(``plan=``) or a :class:`~repro_torch.session.Session` that owns one
(``session=``, whose drift re-plans it picks up), reports the plan's
entries for the decode path's collectives
(:meth:`GenerationEngine.collective_hints`,
:meth:`GenerationEngine.lowered_collective`), and
:meth:`GenerationEngine.arm_overlap` fuses the plan's certified all-gather
into the wave loop on the virtual mesh: the prefill's gather runs beside
the cache growth, each decode step's beside the next decode
(:func:`repro_torch.kernels.overlap.run_overlapped`).
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
    def __init__(self, model, params, gen_cfg: Optional[GenerationConfig] = None,
                 plan=None, session=None):
        self.model = model
        self.params = params
        self.cfg = gen_cfg or GenerationConfig()
        self.device = model.device
        #: set by arm_overlap(): the planned, certified all-gather
        #: schedule fused with the decode and prefill compute
        self._armed = None
        self.stats: Dict[str, Any] = {"prefill_tokens": 0, "decode_steps": 0}
        #: a repro_torch.session.Session may own the plan: its (lazily
        #: compiled) plan is adopted when no plan is passed, and its drift
        #: re-plans are seen because the engine re-reads session.planned
        self.session = session
        if plan is None and session is not None:
            plan = session.plan() if session.planned is None else session.planned
        #: compiled collective plan (repro_torch.plan.Plan) for the serving
        #: mesh; its per-op entries are surfaced by collective_hints()
        self.plan = plan
        if plan is not None:
            self.stats["plan_fingerprint"] = plan.fingerprint.digest

    def _current_plan(self):
        if self.session is not None and self.session.planned is not None:
            self.plan = self.session.planned       # pick up drift re-plans
        return self.plan

    def collective_hints(self, payload_bytes: float = 1e6) -> Dict[str, Dict]:
        """Per-op plan entries the decode path's collectives map onto.

        TP decode issues an all-gather and a reduce-scatter a layer; MoE
        archs add the EP all-to-all.  Returns {op: entry summary} from
        the plan's nearest size buckets (empty without a plan).
        """
        plan = self._current_plan()
        if plan is None:
            return {}
        out: Dict[str, Dict] = {}
        for op in ("all-gather", "reduce-scatter", "all-to-all"):
            e = plan.lookup(op, payload_bytes)
            if e is not None:
                out[op] = {
                    "algo": e.algo, "chunks": e.chunks,
                    "expected_time": e.expected_time,
                    "speedup_vs_identity":
                        e.best_identity_time / max(e.expected_time, 1e-30),
                }
                if e.program_fingerprint:
                    out[op]["program"] = e.program_fingerprint
        return out

    def lowered_collective(self, op: str, payload_bytes: float = 1e6):
        """The plan's :class:`~repro_torch.collective.Lowered` for ``op``
        at ``payload_bytes`` (:class:`~repro_torch.collective.ScheduleLowering`
        of the entry's program, not certified: :meth:`arm_overlap` and
        :meth:`repro_torch.session.Session.lower` certify), or None when
        there is no plan, no entry, or no lowering."""
        plan = self._current_plan()
        if plan is None:
            return None
        entry = plan.lookup(op, payload_bytes)
        if entry is None:
            return None
        from repro_torch.collective import ScheduleLowering

        lowering = ScheduleLowering()
        prog = entry.program()
        return lowering.lower(prog) if lowering.can_lower(prog) else None

    def arm_overlap(self, mesh, axis: str, payload_bytes: float = 1e6):
        """Fuse the plan's all-gather into the decode and prefill compute.

        Looks up the plan's all-gather entry at ``payload_bytes``, lowers
        it and certifies that exact schedule
        (:func:`repro_torch.analysis.require_certified`), then arms the
        wave loop on the virtual mesh ``mesh`` (a
        :class:`~repro_torch.launch.mesh.PlannedMesh`, whose ``axis`` must
        have the schedule's n slots): each decode step's gather of its
        activation block runs with the next decode as resident compute,
        and the prefill's with the cache growth.  ``generate`` checks the
        gather's postcondition on the first decode step of every wave.
        Returns the certified schedule.
        """
        from repro_torch.analysis import require_certified
        from repro_torch.collective import ScheduleLowering

        plan = self._current_plan()
        if plan is None:
            raise ValueError("arm_overlap() needs a plan (or session)")
        entry = plan.lookup("all-gather", payload_bytes)
        if entry is None:
            raise ValueError(
                f"plan has no all-gather entry near {payload_bytes:.0f} B")
        prog = entry.program()
        sched = ScheduleLowering().lower_schedule(prog)
        require_certified(prog, sched)
        if mesh.axis_size(axis) != sched.n:
            raise ValueError(f"mesh axis {axis!r} has {mesh.axis_size(axis)} "
                             f"ranks, schedule wants {sched.n}")
        self._armed = sched
        self.stats["overlap_algo"] = sched.algorithm
        return sched

    def _gather(self, payload: torch.Tensor, compute: Callable[[], Any]):
        """The armed all-gather of ``payload`` with ``compute`` resident;
        the reference's engine adds with plain ``+`` here."""
        from repro_torch.kernels.overlap import run_overlapped

        gathered, (res,) = run_overlapped(
            payload, self._armed, compute=[compute],
            use_kernel_add=False)
        return gathered, res

    def _ag_payload(self, logits: torch.Tensor) -> torch.Tensor:
        """Rank-major ``[n, D]`` all-gather input from an activation block.

        The step's logits block stands in for the TP activations the
        gather moves on a real mesh, padded so every rank's shard is a
        whole number of schedule pieces.
        """
        n, k = self._armed.n, max(1, self._armed.chunk_factor)
        flat = logits.reshape(-1)
        per = -(-flat.numel() // n)
        per = -(-per // k) * k
        return F.pad(flat, (0, n * per - flat.numel())).reshape(n, per)

    def _check_gather(self, payload: torch.Tensor, gathered: torch.Tensor) -> None:
        """End-to-end postcondition of the wave's first overlapped gather."""
        from repro_torch.kernels.schedule_runner import check_postcondition

        bad = check_postcondition(self._armed, payload, gathered)
        if bad:
            raise RuntimeError(
                "overlapped all-gather violated its postcondition: "
                + "; ".join(bad[:3]))
        obs.metrics().counter("serve.overlap.postcondition_ok").inc()

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = F.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.inference_mode()
    def generate(self, prompts: List[List[int]],
                 frontend_embeds: Optional[torch.Tensor] = None,
                 max_new_tokens: Optional[int] = None
                 ) -> List[List[int]]:
        """One wave: equal-length prompts -> generated continuations.

        ``frontend_embeds`` (the VLM's image embeddings, Whisper's audio
        frames) go to the model's ``prefill``.
        """
        lens = {len(p) for p in prompts}
        if len(lens) != 1:
            raise ValueError(f"a wave needs equal prompt lengths, got {lens}")
        max_new = max_new_tokens or self.cfg.max_new_tokens
        eos = self.cfg.eos_token
        tokens = torch.tensor(prompts, dtype=torch.long, device=self.device)
        B, P = tokens.shape

        with obs.tracer().span("serve.prefill", batch=B, prompt_len=P):
            logits, cache = self.model.prefill(self.params, tokens,
                                               frontend_embeds)
        self.stats["prefill_tokens"] += B * P
        # grow the cache to P + max_new slots (a model whose cache has a
        # fixed size says how through its own ``grow_cache``); when armed,
        # the planned all-gather of the prompt activations rides along,
        # with the cache growth as its resident compute
        grow = getattr(self.model, "grow_cache", _grow_cache)
        if self._armed is not None:
            payload = self._ag_payload(logits)
            with obs.tracer().span("serve.overlap.prefill",
                                   bytes=float(payload.numel()
                                               * payload.element_size())):
                _, cache = self._gather(
                    payload, lambda: grow(cache, P, P + max_new))
        else:
            cache = grow(cache, P, P + max_new)

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
                if self._armed is not None:
                    # step t's planned all-gather (of step t's activation
                    # block) runs while step t+1's decode does
                    payload = self._ag_payload(logits)
                    gathered, (logits, cache) = self._gather(
                        payload, lambda: self.model.decode_step(
                            self.params, cur, cache))
                    if t == 0:
                        self._check_gather(payload, gathered)
                else:
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
#: (negative index).  State caches (wkv, h, conv, *_sx) never grow, nor do
#: Whisper's cross-attention xk/xv (fixed at the audio context).
_SEQ_DIM = {"k": -2, "v": -2, "ckv": -2, "k_rope": -2}


def _grow_cache(cache: Any, cur_len: int, new_len: int) -> Any:
    """Pad the sequence dim of prefill caches to decode headroom.

    Key-aware: only KV/latent buffers grow; recurrent states and Whisper's
    cross-attention k/v pass through.  A model whose cache has a fixed
    size (the hybrid's ring buffers) brings its own ``grow_cache``, which
    the engine calls instead.
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
