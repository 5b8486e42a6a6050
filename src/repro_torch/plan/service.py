"""Thread-safe planning service (a copy of ``repro.plan.service``).

A production fleet has many jobs arriving concurrently, most of them on
the same fabric with the same handful of collective mixes.  Compiling is
seconds; serving a compiled plan must be microseconds.  The service
front-end therefore:

* checks the fingerprint-keyed :class:`~repro_torch.plan.cache.PlanCache`
  first (warm path: an LRU dict probe);
* **deduplicates** concurrent misses — requests that agree on
  (fabric fingerprint, mix key, mesh shape) while a compile is already
  in flight join that compile's future instead of starting their own;
* runs compiles on a small worker pool so distinct fabrics/mixes compile
  concurrently;
* **batches** via :meth:`request_many`: requests sharing a fingerprint
  have their mixes unioned into one compile whose plan serves every
  caller (entries are keyed per (op, bucket, group), so a superset plan
  answers each sub-mix exactly).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.faults.retry import RetryPolicy, call_with_retries

from .cache import PlanCache, fabric_fingerprint
from .compiler import JobMix, Plan, PlanCompiler

__all__ = ["PlanningService"]


def _mesh_suffix(mesh_shape, axis_names) -> str:
    if mesh_shape is None:
        return ""
    return f"|mesh={tuple(mesh_shape)}:{tuple(axis_names or ())}"


class PlanningService:
    """Concurrent front-end over a :class:`PlanCompiler` + :class:`PlanCache`."""

    def __init__(self, compiler: PlanCompiler,
                 cache: Optional[PlanCache] = None, max_workers: int = 2,
                 retry: Optional[RetryPolicy] = None):
        self.compiler = compiler
        self.cache = cache if cache is not None else PlanCache()
        #: when set, compiles transiently failing (a flaky probe feeding
        #: NaNs, a racing re-attach) are retried under capped backoff
        #: before the failure reaches the consumer's future
        self.retry = retry
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="repro-plan")
        self._lock = threading.Lock()
        self._inflight: Dict[Tuple[str, str], Future] = {}
        self._inflight_fp: Dict[Tuple[str, str], object] = {}
        self.stats = {"requests": 0, "cache_hits": 0,
                      "dedup_joins": 0, "compiles": 0}

    # -- single request ---------------------------------------------------
    def submit(self, probe, mix: JobMix,
               mesh_shape: Optional[Sequence[int]] = None,
               axis_names: Optional[Sequence[str]] = None) -> Future:
        """Plan future for (probe, mix); dedupes against in-flight work."""
        lat, bw = PlanCompiler._matrices(probe)
        fp = fabric_fingerprint(lat, bw,
                                hierarchy=getattr(probe, "hierarchy", None))
        request_key = mix.key() + _mesh_suffix(mesh_shape, axis_names)
        # The full lookup may scan the persistent store — keep that disk
        # I/O OUTSIDE the service lock (the cache locks itself) so
        # concurrent requests for distinct fabrics don't serialize.
        cached = self.cache.get(fp, request_key)
        with self._lock:
            self.stats["requests"] += 1
            obs.metrics().counter("plan.service.requests").inc()
            if cached is None:
                # a compile may have landed between the lookup and here
                cached = self.cache.peek_mem(fp, request_key)
            if cached is not None:
                self.stats["cache_hits"] += 1
                obs.metrics().counter("plan.service.cache_hits").inc()
                fut: Future = Future()
                fut.set_result(cached)
                return fut
            # join an in-flight compile whose fingerprint fuzzily matches
            for (digest, rk), fut in self._inflight.items():
                if rk != request_key:
                    continue
                in_fp = self._inflight_fp.get((digest, rk))
                if in_fp is not None and fp.matches(in_fp, self.cache.tol):
                    self.stats["dedup_joins"] += 1
                    obs.metrics().counter("plan.service.dedup_joins").inc()
                    return fut
            key = (fp.digest, request_key)
            fut = self._pool.submit(self._compile, key, fp, probe, mix,
                                    mesh_shape, axis_names, request_key)
            self._inflight[key] = fut
            self._inflight_fp[key] = fp
            return fut

    def request(self, probe, mix: JobMix,
                mesh_shape: Optional[Sequence[int]] = None,
                axis_names: Optional[Sequence[str]] = None) -> Plan:
        return self.submit(probe, mix, mesh_shape, axis_names).result()

    # -- batched requests -------------------------------------------------
    def request_many(
        self,
        requests: Sequence[Tuple[object, JobMix]],
    ) -> List[Plan]:
        """Serve several (probe, mix) requests, sharing compiles.

        Requests whose fabrics fingerprint-match are folded into ONE
        compile of the union mix; every caller receives that superset
        plan (lookups per (op, bucket, group) answer each sub-mix).
        """
        groups: List[Tuple[object, object, List[int], List[JobMix]]] = []
        for i, (probe, mix) in enumerate(requests):
            lat, bw = PlanCompiler._matrices(probe)
            fp = fabric_fingerprint(lat, bw,
                                    hierarchy=getattr(probe, "hierarchy", None))
            for g in groups:
                if fp.matches(g[1], self.cache.tol):
                    g[2].append(i)
                    g[3].append(mix)
                    break
            else:
                groups.append((probe, fp, [i], [mix]))

        out: List[Optional[Plan]] = [None] * len(requests)
        futures = []
        for probe, _fp, idxs, mixes in groups:
            union = JobMix(
                requests=tuple(r for m in mixes for r in m.requests),
                name="+".join(dict.fromkeys(m.name for m in mixes)),
            )
            futures.append((idxs, self.submit(probe, union)))
        for idxs, fut in futures:
            plan = fut.result()
            for i in idxs:
                out[i] = plan
        return out  # type: ignore[return-value]

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "PlanningService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals --------------------------------------------------------
    def _compile(self, key, fp, probe, mix, mesh_shape, axis_names,
                 request_key) -> Plan:
        try:
            def compile_once() -> Plan:
                return self.compiler.compile(
                    probe, mix, mesh_shape=mesh_shape, axis_names=axis_names,
                    fingerprint=fp)

            with obs.tracer().span("plan.service.compile", mix=mix.name):
                if self.retry is not None:
                    plan = call_with_retries(compile_once, self.retry)
                else:
                    plan = compile_once()
            with self._lock:
                self.stats["compiles"] += 1
                obs.metrics().counter("plan.service.compiles").inc()
            self.cache.put(plan, request_key)
            return plan
        finally:
            with self._lock:
                self._inflight.pop(key, None)
                self._inflight_fp.pop(key, None)
