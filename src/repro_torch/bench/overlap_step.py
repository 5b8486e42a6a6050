"""Overlapped train step: planned+bucketed vs planned-sequential vs identity.

The port of the reference's ``benchmarks/overlap_step.py`` (``python -m
repro_torch bench --scenario overlap``).  Two sections, one JSON:

* **modeled fabric** (numpy) — on the oversubscribed scrambled 8-node
  datacenter (:func:`std_fabric`), price the planned all-reduce with
  :class:`~repro_torch.collective.SimExecutor` at the full payload and at
  the plan-selected bucket payload, then roll the bucket-pipeline
  recurrence: bucket ``b``'s transfer may start once backward slice
  ``b`` is done and the wire is free.  Compute is pinned to the
  sequential comm time (the balanced compute:comm boundary), so the
  speedup isolates what pipelining and rank reordering hide.  Gate:
  ``bucketed`` must model at least ``SPEEDUP_FLOOR`` times the
  planned-sequential step.  :func:`_plan_overlap` and
  :func:`_pipeline_model` equal the reference's to the last digit.
* **host execution** — in process, on the 8-rank virtual mesh (the
  reference spawns an 8-device JAX host mesh instead): ``qwen2-0.5b``
  (``.smoke()`` under ``smoke``, the published widths otherwise) in f32 on
  ``SyntheticLM(vocab, 16, 8, seed=0)``'s batch 0; the baseline step
  (:func:`~repro_torch.train.make_train_step`); for each overlap mode the
  planned step (:func:`~repro_torch.train.make_overlap_train_step` over an
  :class:`~repro_torch.train.OverlapGradReducer` on the certified
  all-reduce at the plan's algorithm, order and chunking), its loss held
  to the baseline's at ``rtol=2e-5``; the reducer alone on stacked grads
  (comm-only) and :func:`~repro_torch.train.stacked_grads` alone
  (compute-only: on one card the 8 ranks' backward passes run one after
  another, where the reference's 8 devices run them side by side); the
  exposed-communication fraction; the schedule's postcondition on the
  reference's ``arange`` input.  The transport follows ``train``'s rule:
  the peer-memory ring kernel on CUDA for a ring schedule, the schedule
  runner otherwise.

Every time is an ``obs.tracer().timer`` (``bench.base``,
``bench.<mode>``, ``bench.comm_only``, ``bench.compute_only``) on the host
clock, the device synchronised inside the timed window; each timed
function runs once untimed first, and that run's loss is the one held to
the baseline's.  The host section runs on CUDA unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import sys
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.collective import ScheduleLowering, SimExecutor
from repro_torch.fabric import make_datacenter, probe_fabric, scramble
from repro_torch.plan import CollectiveRequest, JobMix, PlanCompiler, SolveBudget

__all__ = ["N", "SIZE", "SPEEDUP_FLOOR", "std_fabric", "host_setup", "run"]

N = 8
SIZE = 4 << 20          # full grad payload priced in the modeled section
SPEEDUP_FLOOR = 1.15
#: the overlapped loss against the baseline's (the reference's tolerance)
LOSS_RTOL = 2e-5
SEQ = 16                # SyntheticLM sequence length of the host section
#: the host section's model dtype at every width.  In bf16 a rank's GEMMs on
#: one row round otherwise than the baseline's on eight, which the loss gate
#: (an f32 tolerance) would read as a divergence
DTYPE = "float32"


def std_fabric(n: int, seed: int = 0):
    """The scrambled multi-tenant datacenter every reference benchmark
    shares (a copy of ``benchmarks/common.py``'s)."""
    fab, _ = scramble(make_datacenter(n, seed=seed), seed=seed + 1)
    return fab


def _plan_overlap(seed: int = 0) -> dict:
    """Plan the all-reduce on the oversubscribed scrambled fabric."""
    fab = std_fabric(N, seed=seed)
    probe = probe_fabric(fab, seed=seed)
    mix = JobMix((CollectiveRequest("all-reduce", float(SIZE)),),
                 name="overlap")
    plan = PlanCompiler(fabric=fab,
                        budget=SolveBudget(iters=200, chains=4)).compile(
        probe, mix)
    entry = plan.lookup("all-reduce", float(SIZE))
    bucket = plan.lookup("all-reduce", entry.bucket_bytes or float(SIZE))
    sim = SimExecutor(fab)

    # the reducer path runs only schedules that end replicated; price
    # the same ring-at-planned-order fallback reducer_from_plan applies
    algo_fallback = ScheduleLowering().lower_schedule(
        entry.program()).postcondition != "allreduce"
    if algo_fallback:
        entry = dataclasses.replace(entry, algo="ring", algo_kwargs={})
        bucket = dataclasses.replace(bucket, algo="ring", algo_kwargs={})

    def priced(e, size):
        prog = dataclasses.replace(e, size_bytes=float(size)).program()
        return float(sim.estimate(prog))

    t_full_planned = priced(entry, SIZE)
    t_full_identity = priced(
        dataclasses.replace(entry, perm=tuple(range(N)), chunks=1), SIZE)
    bb = float(entry.bucket_bytes or SIZE)
    n_buckets = int(np.ceil(SIZE / bb))
    t_bucket = priced(bucket, bb)
    return {
        "fabric": "scrambled datacenter, 8 nodes (std_fabric)",
        "size_bytes": SIZE,
        "algo": entry.algo,
        "algo_fallback": bool(algo_fallback),
        "algo_kwargs": {k: int(v) for k, v in entry.algo_kwargs.items()},
        "chunks": int(entry.chunks),
        "perm": [int(p) for p in entry.perm],
        "bucket_bytes": bb,
        "n_buckets": n_buckets,
        "sim_full_planned_s": t_full_planned,
        "sim_full_identity_s": t_full_identity,
        "sim_bucket_s": t_bucket,
    }


def _pipeline_model(o: dict) -> dict:
    """Bucket-pipeline makespan at the balanced compute:comm boundary.

    ``C`` (backward compute) is pinned to the planned sequential comm
    time; bucket ``b`` may go on the wire once backward slice ``b`` is
    done AND the previous bucket left the wire (one serialized fabric).
    """
    C = o["sim_full_planned_s"]
    nb, tb = o["n_buckets"], o["sim_bucket_s"]
    t_seq = C + o["sim_full_planned_s"]            # no overlap
    t_seq_identity = C + o["sim_full_identity_s"]
    finish = 0.0
    for b in range(nb):
        ready = C * (b + 1) / nb
        finish = max(ready, finish) + tb
    t_bucketed = max(C, finish)
    return {
        "compute_s": C,
        "modeled_sequential_s": t_seq,
        "modeled_sequential_identity_s": t_seq_identity,
        "modeled_bucketed_s": t_bucketed,
        "modeled_exposed_s": max(0.0, t_bucketed - C),
        "modeled_exposed_fraction": max(0.0, t_bucketed - C) / t_bucketed,
        "speedup_bucketed_vs_sequential": t_seq / t_bucketed,
        "speedup_bucketed_vs_identity": t_seq_identity / t_bucketed,
        "floor": SPEEDUP_FLOOR,
    }


def host_setup(o: dict, smoke: bool, device, params: Optional[Any] = None
               ) -> SimpleNamespace:
    """What the host section runs on: the model and its state, the batch,
    the bucket payload ``bb = min(plan bucket, param_bytes / 2)`` and the
    certified all-reduce at the plan's algorithm, order and chunking."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, host_batch
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.train import TrainState, certified_allreduce, init_state
    from repro_torch.train.train_step import batch_on
    from repro_torch.tree import tree_leaves

    cfg = get_config("qwen2-0.5b")
    # f32, the reference's (its smoke config's dtype), whose rtol the loss
    # gate keeps; the published widths' config is bf16 by default
    cfg = dataclasses.replace(cfg.smoke() if smoke else cfg, dtype=DTYPE)
    model = get_model(cfg, device=device)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        state = init_state(model, gen)
    else:
        state = TrainState(params=params, opt=init_opt(params),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=device))
    batch = batch_on(host_batch(SyntheticLM(cfg.vocab_size, SEQ, N, seed=0),
                                0), device)
    pbytes = float(sum(t.numel() * t.element_size()
                       for t in tree_leaves(state.params)))
    bb = min(o["bucket_bytes"], pbytes / 2)
    sched = certified_allreduce(N, bb, algo=o["algo"], perm=o["perm"],
                                chunk_factor=max(1, o["chunks"]),
                                **o["algo_kwargs"])
    return SimpleNamespace(cfg=cfg, model=model, opt=AdamWConfig(lr=1e-3),
                           state=state, batch=batch, param_bytes=pbytes,
                           bucket_bytes=bb, schedule=sched)


def _run_host(o: dict, smoke: bool, device, reps: int,
              params: Optional[Any] = None) -> Dict[str, Any]:
    """The host section on the virtual mesh (the reference's
    ``_HOST_SCRIPT``, in process)."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels.overlap import run_overlapped
    from repro_torch.kernels.schedule_runner import check_postcondition
    from repro_torch.train import (
        OverlapGradReducer, make_overlap_train_step, make_train_step,
        partition_tree, stacked_grads)

    n = N
    h = host_setup(o, smoke, device, params)
    model, opt, state, batch = h.model, h.opt, h.state, h.batch
    bb, sched = h.bucket_bytes, h.schedule
    # train's rule: the peer-memory ring kernel on CUDA for a ring
    # schedule, the schedule runner otherwise
    transport = ("peer_ring" if device.type == "cuda"
                 and sched.algorithm == "ring" else "runner")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def timed(name, fn):
        """``(seconds a call, the untimed first call's output)``."""
        first = fn()
        t = obs.tracer().timer(name)
        with t:
            for _ in range(reps):
                fn()
            sync()
        return t.elapsed / reps, first

    out: Dict[str, Any] = {
        "param_bytes": h.param_bytes, "bucket_bytes": bb,
        "config": h.cfg.name,
        "device": str(device), "transport": transport, "reps": reps,
        "buckets": len(partition_tree(state.params, bb))}

    base = make_train_step(model, opt)
    out["baseline_s"], first = timed(
        "bench.base", lambda: base(state, batch)[1]["loss"])
    base_loss = float(first)
    out["baseline_loss"] = base_loss

    for mode in (["bucketed"] if smoke else ["sequential", "bucketed", "fused"]):
        red = OverlapGradReducer(sched, bucket_bytes=bb, mode=mode,
                                 transport=transport)
        step = make_overlap_train_step(model, opt, red)
        out[f"{mode}_s"], first = timed(
            f"bench.{mode}", lambda: step(state, batch)[1]["loss"])
        loss = float(first)
        out[f"{mode}_loss"] = loss
        out[f"{mode}_loss_ok"] = bool(np.isclose(loss, base_loss,
                                                 rtol=LOSS_RTOL))

    # exposed-comm fraction: timers around the reducer alone on stacked
    # grads, the 8 ranks' grads alone, and the full bucketed step
    _, gstack = stacked_grads(model, state.params, batch, n)
    red = OverlapGradReducer(sched, bucket_bytes=bb, mode="bucketed",
                             transport=transport)
    t_comm, _ = timed("bench.comm_only", lambda: red(gstack)[0])
    del gstack
    # the grads are made and dropped each call; only the losses are kept
    t_compute, _ = timed("bench.compute_only",
                         lambda: stacked_grads(model, state.params, batch, n)[0])
    t_full = out.get("bucketed_s", t_comm + t_compute)
    exposed = max(0.0, t_full - t_compute)
    out["comm_only_s"] = t_comm
    out["compute_only_s"] = t_compute
    # fraction of the full step that is exposed (non-hidden) communication
    out["exposed_comm_fraction"] = min(1.0, exposed / max(t_full, 1e-12))

    # the certified schedule's postcondition on the reference's input
    d = sched.n_chunks * max(1, sched.chunk_factor) * 32
    x = np.arange(n * d, dtype=np.float32).reshape(n, d) / 1e3
    res, _ = run_overlapped(torch.as_tensor(x, device=device), sched,
                            use_kernel_add=False)
    out["postcondition_ok"] = not check_postcondition(sched, x, res)
    return out


def _run_meta(seed: int) -> Dict[str, Any]:
    """Provenance stamp of the JSON (the reference's, without git or JAX)."""
    import torch

    return {
        "seed": seed,
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "python": sys.version.split()[0],
        "numpy": np.__version__,
        "torch": torch.__version__,
    }


def run(smoke: bool = False, out_path: Optional[str] = None, seed: int = 0,
        device: Any = "cuda", reps: Optional[int] = None,
        params: Optional[Any] = None) -> Dict[str, Any]:
    """Both sections; prints the reference's rows, writes ``out_path``.

    ``reps`` defaults to the reference's (2 under ``smoke``, else 5);
    ``params`` (a tree in the port's layout) replaces the seed-0 weights.
    Raises ``RuntimeError`` when the gate fails, after writing the JSON.
    """
    from repro_torch import resolve_device

    device = resolve_device(device)
    orders = _plan_overlap(seed=seed)
    model = _pipeline_model(orders)
    host = _run_host(orders, smoke, device,
                     reps if reps is not None else (2 if smoke else 5),
                     params=params)

    equiv_ok = all(host.get(f"{m}_loss_ok", True)
                   for m in ("sequential", "bucketed", "fused"))
    gate_ok = (model["speedup_bucketed_vs_sequential"] >= SPEEDUP_FLOOR
               and equiv_ok and host["postcondition_ok"])

    rows = [
        {"name": "overlap_modeled_sequential",
         "us": model["modeled_sequential_s"] * 1e6,
         "derived": f"algo={orders['algo']};buckets={orders['n_buckets']}"},
        {"name": "overlap_modeled_bucketed",
         "us": model["modeled_bucketed_s"] * 1e6,
         "derived": "speedup="
                    f"{model['speedup_bucketed_vs_sequential']:.2f}x;"
                    f"floor={SPEEDUP_FLOOR}"},
        {"name": "overlap_host_step",
         "us": host.get("bucketed_s", 0.0) * 1e6,
         "derived": f"equiv_ok={equiv_ok};"
                    f"exposed_frac={host['exposed_comm_fraction']:.2f}"},
        {"name": "overlap_gate", "us": 0.0,
         "derived": f"post_ok={host['postcondition_ok']};"
                    f"{'OK' if gate_ok else 'FAIL'}"},
    ]
    results = {
        "benchmark": "overlap_step",
        "smoke": smoke,
        "scenario": orders,
        "modeled": model,
        "host": host,
        "gate_ok": bool(gate_ok),
    }
    for r in rows:
        print(f"{r['name']},{r['us']:.3f},{r['derived']}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(dict(results, meta=_run_meta(seed)), f, indent=2)
        print(f"wrote {out_path}", file=sys.stderr)
    if not gate_ok:
        raise RuntimeError(
            f"overlap gate failed: "
            f"speedup={model['speedup_bucketed_vs_sequential']:.3f} "
            f"equiv_ok={equiv_ok} post_ok={host['postcondition_ok']}")
    return results
