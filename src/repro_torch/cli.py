"""``python -m repro_torch``: the port's command-line interface.

Counterpart of ``repro``'s CLI (``repro/cli.py``), every subcommand::

    python -m repro_torch probe --fabric datacenter --nodes 64
    python -m repro_torch plan  --mesh 8 --payload-bytes 988065536 --dry-run
    python -m repro_torch train --arch qwen2-0.5b --mesh 8 --batch 16 \\
        --seq 1024 --steps 4 --reorder simulate
    python -m repro_torch serve --arch glm4-9b --batch 8 --prompt-len 2048
    python -m repro_torch bench --smoke [--scenario plan|faults|obs|overlap]
    python -m repro_torch analyze [--lint | --program ALGO | --plan | --equiv]
    python -m repro_torch status --format prom
    python -m repro_torch trace export --out trace.json
    python -m repro_torch trace replay [--trace capture.json]

Every subcommand accepts the reference's session arguments:
``--config session.json`` plus ``REPRO_*`` environment overrides
(:meth:`~repro_torch.session.SessionConfig.from_env`) plus explicit
flags, in that precedence order; ``--dump-config`` prints the
resolved config as JSON and exits.

``serve`` plans the serving mix (``--payload-bytes``, 1e6 unless a flag,
a config file or the environment sets one) over ``--mesh`` as ``train``
does (``--reorder simulate``), hands the plan to the engine and prints
its collective hints; a one-rank mesh, the default, plans nothing.

``train`` plans the data-parallel all-reduce through a
:class:`~repro_torch.session.Session` (``--reorder simulate``), builds
the planned virtual mesh (which places data shard i on rank
``order[i]``), turns the plan into the certified reducer
(:meth:`~repro_torch.session.Session.overlap_step`, one peer-memory ring
launch a gradient bucket on CUDA) and runs
:class:`~repro_torch.train.Trainer` with checkpoints.  ``train`` and
``serve`` run on CUDA unless ``--device cpu`` is given (the plain
PyTorch versions of the kernels, and the schedule runner as the
transport); ``--smoke`` picks the reduced same-family config and is off
by default, where the reference's cannot be turned off.  Weights are
random: ``train`` draws them from seed 0, ``serve`` from ``--seed``.
``serve`` takes every family the port has; the VLM and Whisper get the
reference's front-end stub (ones of ``[batch, n_img_tokens |
n_audio_ctx, d_model]``), and an MoE arch on a mesh with a data axis of
more than one rank arms the EP all-to-all
(:func:`repro_torch.parallel.moe_a2a.arm_ep`) in the plan's order.
``train`` takes every family but ``encdec``, whose loss needs audio the
synthetic batches do not carry, and ``moe``, whose training on the card
waits for the sharding specs.

``bench``, ``analyze``, ``status`` and ``trace`` are the reference's,
host-only numpy over the port's planner, with the reference's JSON and
exit codes; the one device path is ``bench --scenario overlap``
(:mod:`repro_torch.bench.overlap_step`), which runs the overlapped train
step on CUDA unless ``--device cpu`` is given and writes its JSON only
where ``--out`` says (the reference writes ``BENCH_overlap.json`` in the
working directory).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

from repro_torch import obs
from repro_torch.launch.train import DEFAULT_BUCKET_BYTES

__all__ = ["main", "build_parser", "session_config_from_args",
           "run_obs_scenario"]
#: linear warm-up steps of ``train``'s learning rate, as the reference's
#: ``train`` (``repro/cli.py:287``)
WARMUP_STEPS = 10


# ---------------------------------------------------------------------------
# shared session arguments (as the reference's)
# ---------------------------------------------------------------------------

def _add_session_args(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("session config")
    g.add_argument("--config", default=None, metavar="JSON",
                   help="SessionConfig JSON file to start from")
    g.add_argument("--fabric", default=None,
                   choices=["datacenter", "tpu-fleet", "live"])
    g.add_argument("--nodes", type=int, default=None,
                   help="datacenter fabric size")
    g.add_argument("--pods", type=int, default=None,
                   help="tpu-fleet pod count")
    g.add_argument("--pod-shape", default=None, metavar="AxB")
    g.add_argument("--scramble-seed", type=int, default=None,
                   help="relabel nodes (the cloud's random IP list)")
    g.add_argument("--fabric-seed", type=int, default=None)
    g.add_argument("--probe-seed", type=int, default=None)
    g.add_argument("--probe-mode", default=None, choices=["dense", "sparse"],
                   help="dense n^2 probing or budgeted sparse probing")
    g.add_argument("--sparse", action="store_true", default=None,
                   help="shorthand for --probe-mode sparse")
    g.add_argument("--probe-budget", type=float, default=None,
                   help="sparse probe budget as a fraction of n(n-1)")
    g.add_argument("--mesh", default=None, metavar="AxB[xC]",
                   help="N-D mesh shape, e.g. 8x8 or 2x16x16")
    g.add_argument("--axes", default=None, metavar="a,b",
                   help="mesh axis names, e.g. data,model")
    g.add_argument("--payload-bytes", type=float, default=None)
    g.add_argument("--moe", action="store_true", default=None,
                   help="add the EP all-to-all to the default mix")
    g.add_argument("--plan-cache-dir", default=None,
                   help="persist compiled plans across launches")
    g.add_argument("--iters", type=int, default=None,
                   help="solver SA iterations per entry")
    g.add_argument("--chains", type=int, default=None)
    g.add_argument("--solver-engine", default=None,
                   choices=["vectorized", "reference"])
    g.add_argument("--solver-backend", default=None,
                   choices=["numpy", "jax"],
                   help="jax: the batched torch evaluator "
                        "(kernels/solver_eval.py)")
    g.add_argument("--solver-seed", type=int, default=None)
    g.add_argument("--drift-threshold", type=float, default=None)
    g.add_argument("--dump-config", action="store_true",
                   help="print the resolved SessionConfig JSON and exit")


def session_config_from_args(args: argparse.Namespace,
                             workload: Optional[str] = None):
    """Resolve file -> environment -> explicit flags into a SessionConfig."""
    from repro_torch.session import SessionConfig

    base = SessionConfig.load(args.config) if args.config else SessionConfig()
    cfg = SessionConfig.from_env(base=base)

    updates: Dict[str, Any] = {}
    fabric: Dict[str, Any] = {}
    if args.fabric is not None:
        fabric["kind"] = args.fabric
    if args.nodes is not None:
        fabric["nodes"] = args.nodes
    if args.pods is not None:
        fabric["n_pods"] = args.pods
    if getattr(args, "pod_shape", None) is not None:
        fabric["pod_shape"] = args.pod_shape
    if args.scramble_seed is not None:
        fabric["scramble_seed"] = args.scramble_seed
    if args.fabric_seed is not None:
        fabric["seed"] = args.fabric_seed
    if fabric:
        updates["fabric"] = fabric
    probe: Dict[str, Any] = {}
    if args.probe_seed is not None:
        probe["seed"] = args.probe_seed
    if getattr(args, "probe_mode", None) is not None:
        probe["mode"] = args.probe_mode
    if getattr(args, "sparse", None):
        probe["mode"] = "sparse"
    if getattr(args, "probe_budget", None) is not None:
        probe["budget"] = args.probe_budget
    if probe:
        updates["probe"] = probe
    mesh: Dict[str, Any] = {}
    if args.mesh is not None:
        mesh["shape"] = args.mesh
    if args.axes is not None:
        mesh["axis_names"] = args.axes
    if mesh:
        updates["mesh"] = mesh
    solver: Dict[str, Any] = {}
    budget: Dict[str, Any] = {}
    if args.iters is not None:
        budget["iters"] = args.iters
    if args.chains is not None:
        budget["chains"] = args.chains
    if args.solver_engine is not None:
        budget["engine"] = args.solver_engine
    if args.solver_backend is not None:
        budget["backend"] = args.solver_backend
    if budget:
        solver["budget"] = budget
    if args.solver_seed is not None:
        solver["seed"] = args.solver_seed
    if solver:
        updates["solver"] = solver
    if args.plan_cache_dir is not None:
        updates["cache"] = {"dir": args.plan_cache_dir}
    if args.drift_threshold is not None:
        updates["drift"] = {"threshold": args.drift_threshold}
    if args.payload_bytes is not None:
        updates["payload_bytes"] = args.payload_bytes
    if args.moe:
        updates["moe"] = True
    if workload is not None:
        updates["workload"] = workload
    return cfg.replace(**updates) if updates else cfg


def _maybe_dump(args: argparse.Namespace, cfg) -> bool:
    if getattr(args, "dump_config", False):
        print(cfg.to_json())
        return True
    return False


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------

def cmd_probe(args: argparse.Namespace) -> int:
    import numpy as np

    from repro_torch.session import Session

    cfg = session_config_from_args(args)
    if _maybe_dump(args, cfg):
        return 0
    with Session(cfg) as s:
        s.attach()
        probe = s.probe
        lat = probe.lat
        off = lat[~np.eye(lat.shape[0], dtype=bool)] if lat.shape[0] > 1 \
            else np.zeros(1)
        print(f"[probe] fabric={cfg.fabric.kind} n={probe.n} "
              f"lat p10={np.percentile(off, 10) * 1e6:.1f}us "
              f"p50={np.percentile(off, 50) * 1e6:.1f}us "
              f"p90={np.percentile(off, 90) * 1e6:.1f}us "
              f"bw={'probed' if probe.bw is not None else 'n/a'}")
        if getattr(probe, "probes_used", 0):
            print(f"[probe] sparse: {probe.probes_used} directed probes "
                  f"({probe.probe_fraction * 100:.1f}% of dense n(n-1), "
                  f"budget {probe.probe_budget * 100:.0f}%)")
        if s.hierarchy is not None:
            print(s.hierarchy.describe())
        if args.out:
            payload = {
                "n": probe.n,
                "lat": probe.lat.tolist(),
                "bw": None if probe.bw is None else
                      np.where(np.isfinite(probe.bw), probe.bw, -1.0).tolist(),
                "n_probes": probe.n_probes,
                "percentile": probe.percentile,
            }
            if s.hierarchy is not None:
                payload["hierarchy"] = s.hierarchy.to_dict()
                payload["probes_used"] = int(getattr(probe, "probes_used", 0))
            with open(args.out, "w") as f:
                json.dump(payload, f)
            print(f"[probe] wrote {args.out}")
    return 0


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

def cmd_plan(args: argparse.Namespace) -> int:
    from repro_torch.session import Session

    cfg = session_config_from_args(args)
    if args.dry_run:
        # a dry run must leave no trace: no persistent cache writes
        cfg = cfg.replace(cache={"dir": None})
    if _maybe_dump(args, cfg):
        return 0
    with Session(cfg) as s:
        plan = s.plan()
        hit = "cache hit" if s.service.stats["cache_hits"] else \
            f"compiled in {plan.compile_seconds:.2f}s"
        mode = "dry-run: " if args.dry_run else ""
        print(f"[plan] {mode}{plan.fingerprint.digest} ({hit}) "
              f"mix={cfg.workload} n={plan.n}")
        for (op, bucket, group), e in sorted(plan.entries.items()):
            fp = f" prog={e.program_fingerprint}" if e.program_fingerprint \
                else ""
            print(f"  {op:<15} bucket=2^{bucket:<3} group={len(group):>4} "
                  f"-> {e.algo:<20} chunks={e.chunks} "
                  f"t={e.expected_time * 1e3:.3f}ms "
                  f"({e.best_identity_time / max(e.expected_time, 1e-30):.2f}x "
                  f"vs identity){fp}")
        if plan.mesh_plan is not None:
            mp = plan.mesh_plan
            print(f"  mesh {'x'.join(map(str, mp.assignment.shape))} "
                  f"cost {mp.baseline_cost:.5f} -> {mp.cost:.5f} "
                  f"({mp.baseline_cost / max(mp.cost, 1e-30):.2f}x)")
        if plan.meta.get("hierarchy"):
            from repro_torch.fabric import HierarchyModel

            tree = HierarchyModel.from_dict(plan.meta["hierarchy"])
            for line in tree.describe().splitlines():
                print(f"  {line}")
        if args.out:
            # an explicit --out is a user-requested artifact, written
            # even under --dry-run (which only skips the plan *store*)
            with open(args.out, "w") as f:
                f.write(plan.to_json())
            print(f"[plan] wrote {args.out}")
    return 0


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _payload_given(args: argparse.Namespace) -> bool:
    return (args.payload_bytes is not None or args.config is not None
            or "REPRO_PAYLOAD_BYTES" in os.environ)


def train_schedule(lr: float, steps: int):
    """``train``'s learning rate by step: the reference's
    ``cosine_schedule(lr, 10, steps)``, whatever the run's length."""
    from repro_torch.optim import cosine_schedule

    return cosine_schedule(lr, WARMUP_STEPS, steps)


def device_memory(device) -> Optional[int]:
    """The card's memory in bytes; None on the CPU, where nothing is
    refused for memory."""
    import torch

    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def cmd_train(args: argparse.Namespace) -> int:
    """``train``: plan, then train over the mesh's virtual ranks.

    A mesh without a model axis (``--mesh 8``) is data parallel: the
    overlapped step over the planned all-reduce.  A ``(data, model)`` or
    ``(pod, data, model)`` mesh with a model axis of 2 or more runs the
    tensor-parallel, ZeRO-1 step (:mod:`repro_torch.train.sharded_step`):
    every model-axis sum a certified ring over the model group's slots,
    the gradients all-reduced over the data-parallel ranks.  An MoE arch
    on 2 or more data ranks that divide its experts runs the EP step
    (:class:`~repro_torch.train.sharded_step.EPTrainStep`) on ``(data,)``
    or ``(data, model)``: the plan's all-to-all order armed by
    ``configure_sp``, the experts ``E/d`` a data rank, the all-reduce
    planned on and run over the replicated leaves only.  Where the data
    axis does not divide the experts, EP cannot arm and the reference
    trains data-parallel on ``moe_dense``: so does
    :class:`~repro_torch.train.sharded_step.DenseMoETrainStep`, every
    leaf all-reduced; its memory is reckoned first, and on the card a
    reckoning over the card's memory refuses the run.
    """
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import (
        apply_planned, make_mesh, parse_mesh, planning_session)
    from repro_torch.launch.train import build_train_step, train_layout
    from repro_torch.models import get_model
    from repro_torch.models.layers import clear_sequence_parallel
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import moe_a2a
    from repro_torch.train.sharded_step import expert_leaves, param_shapes
    from repro_torch.tree import tree_leaves

    cfg = session_config_from_args(args, workload="train")
    if _maybe_dump(args, cfg):
        return 0
    device = resolve_device(args.device)
    shape, axes = parse_mesh(args.mesh)

    # every check below reads the config that runs
    arch = get_config(args.arch)
    if args.smoke:
        arch = dataclasses.replace(arch.smoke(), vocab_size=2048)
    lay = train_layout(arch, shape, axes, batch=args.batch)
    m, dp, n, ep = lay["m"], lay["dp"], lay["n"], lay["ep"]
    model = get_model(arch, device=device)
    shapes = param_shapes(model)
    # the bytes the data axis reduces: under EP the replicated leaves, the
    # experts' gradients being whole on their ranks
    grad_bytes = float(sum(
        t.numel() * t.element_size()
        for t, e in zip(tree_leaves(shapes), expert_leaves(shapes))
        if not (ep and e)))
    if not _payload_given(args):
        # plan the all-reduce this model's gradients actually need
        cfg = cfg.replace(payload_bytes=grad_bytes)

    transport = "peer_ring" if device.type == "cuda" else "runner"
    mode = cfg.overlap.mode if cfg.overlap.mode != "off" else "bucketed"
    session = planning_session(args, moe=bool(arch.n_experts),
                               session_config=cfg)
    bucket_bytes = float(DEFAULT_BUCKET_BYTES)
    if session is None:
        mesh, plan, reducer = make_mesh(shape, axes, device), None, None
    else:
        with session:
            applied = apply_planned(session, device=device)
            mesh, plan = applied.mesh, applied.plan
            reducer = None
            if m == 1:
                reducer = session.overlap_step(total_bytes=grad_bytes,
                                               mode=mode, transport=transport)
            else:
                # the data axis's groups have no plan entry of their own:
                # the planned bucket size, a ring over the dp slots
                entry = plan.lookup("all-reduce", grad_bytes)
                bucket_bytes = float(cfg.overlap.bucket_bytes or
                                     entry.bucket_bytes or grad_bytes)
    opt = AdamWConfig(schedule=train_schedule(args.lr, args.steps))
    try:
        build = build_train_step(
            arch, mesh, device, model=model, opt=opt, plan=plan,
            reducer=reducer, bucket_bytes=bucket_bytes, mode=mode,
            use_kernel_add=cfg.overlap.use_kernel_add,
            card_bytes=device_memory(device), log=print)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        ds = SyntheticLM(arch.vocab_size, args.seq, args.batch, seed=0)
        return _train_run(args, arch, build, plan, gen, ds, bucket_bytes)
    finally:
        moe_a2a.clear_ep()
        clear_sequence_parallel()


def _train_run(args, arch, build, plan, gen, ds, bucket_bytes) -> int:
    """``train`` past its plan: the step :func:`build_train_step
    <repro_torch.launch.train.build_train_step>` picked for the mesh and
    the arch (``build``), its state drawn from ``gen``; run the trainer,
    print its report."""
    from repro_torch.data import batches as mesh_batches
    from repro_torch.parallel import moe_a2a
    from repro_torch.parallel.sharding import batch_spec
    from repro_torch.parallel.tensor import data_groups, model_groups
    from repro_torch.train import Trainer, TrainerConfig, partition_tree

    mesh, reducer, tp_step = build.mesh, build.reducer, build.sharded
    m, dp, n = build.layout["m"], build.layout["dp"], build.layout["n"]
    axes, ep, memory = mesh.axis_names, build.layout["ep"], build.memory
    device = build.model.device
    step_fn = build.step
    state = build.state(gen)
    if build.kind == "ep":
        rep = tp_step.replicated(state.params)
        rep_bytes = sum(t.numel() * t.element_size() for t in rep)
        buckets = partition_tree(rep, reducer.bucket_bytes)
        entry = None
        if plan is not None:
            cands = [e for (op, _b, grp), e in plan.entries.items()
                     if op == "all-to-all" and len(grp) == dp]
            entry = max(cands, key=lambda e: e.size_bytes) if cands else None
        order = moe_a2a._EP_STATE["a2a_order"]
        print(f"[train] {arch.name} on {device}: mesh {args.mesh} "
              f"({', '.join(axes)}), EP over {dp} data-parallel ranks x "
              f"{args.batch // dp} x {args.seq} tokens, "
              f"{arch.n_experts // dp} experts a rank"
              + (f", model axis {m} (experts gathered over it, model-axis "
                 f"groups {model_groups(mesh.order, m)})" if m > 1 else "")
              + f"; EP all-to-all shift order "
              f"{list(order) if order is not None else list(range(dp))}"
              + (f" (the plan's all-to-all entry over {len(entry.group)} "
                 f"nodes, order {list(entry.perm)})" if entry is not None
                 else " (identity: no plan entry maps onto the data axis)")
              + f"; data-axis all-reduce over the replicated leaves: "
              f"{rep_bytes} bytes ({len(rep)} leaves, the experts' "
              f"{sum(tp_step.expert)} not), ring over {dp} ranks "
              f"{list(reducer.schedule.order)}, {len(buckets)} buckets of "
              f"{reducer.bucket_bytes:.0f} bytes, transport "
              f"{reducer.transport}")
        moe_a2a.reset_ep_stats()
    elif build.kind == "dense_moe":
        buckets = partition_tree(state.params, reducer.bucket_bytes)
        print(f"[train] {arch.name} on {device}: mesh {args.mesh} "
              f"({', '.join(axes)}), {dp} data-parallel ranks x "
              f"{args.batch // dp} x {args.seq} tokens, the MoE blocks on "
              f"moe_dense with the routing shares averaged over the ranks "
              f"(the global batch's aux loss)"
              + (f", model axis {m}" if m > 1 else "")
              + f"; data-axis all-reduce of every leaf, the experts' "
              f"included: {memory['weights']} bytes, ring over {dp} ranks "
              f"{list(reducer.schedule.order)}, {len(buckets)} buckets of "
              f"{reducer.bucket_bytes:.0f} bytes, transport "
              f"{reducer.transport}")
    elif build.kind == "tensor_parallel":
        leaves = tp_step.layout.counts()
        buckets = partition_tree(state.params, bucket_bytes)
        print(f"[train] {arch.name} on {device}: mesh {args.mesh} "
              f"({', '.join(axes)}), {dp} data-parallel ranks x "
              f"{args.batch // dp} x {args.seq} tokens, model axis {m}; "
              f"model-axis groups {model_groups(mesh.order, m)} (a certified "
              f"ring each, slot order); data-axis groups "
              f"{data_groups(mesh.order, m)}; {leaves['sharded']} leaves "
              f"sharded, {leaves['replicated']} replicated, "
              f"{leaves['zero1_sliced']} with ZeRO-1 moments; data-axis "
              + (f"all-reduce ring over {dp} ranks, {len(buckets)} buckets of "
                 f"{bucket_bytes:.0f} bytes, transport {reducer.transport}"
                 if reducer is not None else "none (one data-parallel rank)"))
    elif build.kind == "one_rank":
        print(f"[train] {arch.name} on {device}: one rank, no all-reduce")
    else:
        buckets = partition_tree(state.params, reducer.bucket_bytes)
        print(f"[train] {arch.name} on {device}: {n} data-parallel ranks "
              f"x {args.batch // n} x {args.seq} tokens; all-reduce "
              f"{reducer.schedule.algorithm} order "
              f"{list(reducer.schedule.order)}, {len(buckets)} buckets of "
              f"{reducer.bucket_bytes:.0f} bytes, transport "
              f"{reducer.transport}")
    if build.global_batch:
        batches = mesh_batches(ds, mesh, batch_spec(mesh))
    else:
        rows = mesh.batch_rows(args.batch)  # data shard i on rank mesh.order[i]

        def host_batches():
            i = 0
            while True:
                yield ds.batch_rows(i, rows)
                i += 1

        batches = host_batches()

    trainer = Trainer(
        step_fn=step_fn, state=state, batches=batches,
        cfg=TrainerConfig(total_steps=args.steps, ckpt_every=50,
                          ckpt_dir=args.ckpt_dir, log_every=1,
                          bucket_bytes=reducer.bucket_bytes if reducer else 0.0))
    del state           # the trainer holds the only reference from here on
    timer = obs.tracer().timer("cli.train.run", steps=args.steps)
    with timer:
        report = trainer.run()
    h = report["history"]
    for row in h:
        print(f"[train] step {row['step']} loss {row['loss']:.4f} "
              f"{row['sec'] * 1e3:.1f} ms")
    tp_per_step = None
    if tp_step is not None:
        tp_per_step = {k: v / max(len(h), 1) for k, v in tp_step.counts.items()}
        print(f"[train] collectives per step {json.dumps(tp_per_step)}")
    ck = report["checkpoint"]
    print(f"[train] arch={arch.name} steps={report['final_step']} "
          f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} in "
          f"{timer.elapsed:.2f}s; checkpoint step {ck['step']} "
          f"{ck['bytes']} bytes (snapshot {ck['snapshot_s']:.2f}s, write "
          f"{ck['write_s']:.2f}s)")
    summary = {
        "arch": arch.name, "device": str(device), "ranks": n,
        "model": m, "dp": dp, "tp_collectives": tp_per_step,
        "batch": args.batch, "seq": args.seq,
        "steps": report["final_step"],
        "losses": [row["loss"] for row in h],
        "step_s": [row["sec"] for row in h],
        "plan_digest": plan.fingerprint.digest if plan is not None else None,
        "mesh_order": list(mesh.order), "checkpoint": ck,
    }
    if memory is not None:
        summary["dense_moe"] = {"all_reduce_bytes": memory["weights"],
                                "memory_reckoned": memory}
    if ep:
        summary["ep"] = {
            "order": list(order) if order is not None else None,
            "plan_entry_order": list(entry.perm) if entry is not None else None,
            "experts_per_rank": arch.n_experts // dp,
            "replicated_bytes": rep_bytes, **moe_a2a.ep_stats()}
    if reducer is not None:
        summary.update(algorithm=reducer.schedule.algorithm,
                       order=list(reducer.schedule.order),
                       bucket_bytes=reducer.bucket_bytes,
                       buckets=len(buckets), transport=reducer.transport)
    print("[train] report " + json.dumps(summary))
    return 0


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

#: ``serve``'s payload when none is set: the reference's decode-path size
SERVE_PAYLOAD_BYTES = 1e6


def cmd_serve(args: argparse.Namespace) -> int:
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch import build_mesh
    from repro_torch.launch.serve import serve_arch, serving_layout
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, GenerationEngine
    from repro_torch.session import serve_mix

    cfg = session_config_from_args(args, workload="serve")
    # decode payloads are smaller than gradient payloads: the reference's
    # 1e6 unless a flag, a config file or the environment sets one
    if not _payload_given(args):
        cfg = cfg.replace(payload_bytes=SERVE_PAYLOAD_BYTES)
    if _maybe_dump(args, cfg):
        return 0
    device = resolve_device(args.device)
    arch = get_config(args.arch)
    if args.smoke:
        arch = arch.smoke()
    arch = serve_arch(arch, args.attention_impl, args.wkv_impl)
    mix = serve_mix(cfg.payload_bytes, moe=bool(arch.n_experts))
    # a one-rank mesh, or --reorder none, plans nothing
    mesh, plan = build_mesh(args, mix=mix, session_config=cfg, device=device)
    model = get_model(arch, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)

    # the reference's front-end stub: ones of [batch, slots, d_model]
    slots = {"vlm": arch.n_img_tokens, "encdec": arch.n_audio_ctx}.get(arch.family)
    fe = None if slots is None else torch.ones(
        (args.batch, slots, arch.d_model), dtype=torch.float32, device=device)
    prompts = [
        [(11 * i + j) % arch.vocab_size for j in range(args.prompt_len)]
        for i in range(args.batch)
    ]
    eng = GenerationEngine(
        model, params,
        GenerationConfig(max_new_tokens=args.max_new, eos_token=-1), plan=plan)
    if plan is not None:
        print(f"[serve] plan {plan.fingerprint.digest} hints: "
              f"{eng.collective_hints(cfg.payload_bytes)}")
    timer = obs.tracer().timer("cli.serve.generate", batch=args.batch)
    # an MoE arch on a data axis of 2 or more ranks runs its prompts'
    # experts through the EP all-to-all, in the plan's order
    with serving_layout(arch, mesh, plan), timer:
        # ends on a host copy: synchronised
        outs = eng.generate(prompts, frontend_embeds=fe)
    dt = max(timer.elapsed, 1e-9)
    total = sum(len(o) for o in outs)
    print(f"[serve] arch={arch.name} {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    return 0


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------

def cmd_bench_faults(args: argparse.Namespace) -> int:
    """Seeded churn scenario: preempt 25% of the nodes mid-session, let
    the degradation ladder recover, referee the recovered order against
    identity, and rejoin the preempted nodes.  Fails (exit 1) if any
    recovery raises, loses the plan, or serves an order the cost model
    scores worse than identity."""
    from repro_torch.faults import FaultSchedule, FaultyFabric
    from repro_torch.fabric import make_datacenter, scramble
    from repro_torch.session import Session

    n = 16 if args.smoke else 32
    iters = 200 if args.smoke else 400
    fab, _ = scramble(make_datacenter(n, seed=0), seed=1)
    schedule = FaultSchedule.generate(
        n, ticks=8, seed=args.seed, preempt_frac=0.25,
        timeout_rate=0.0, drop_rate=0.0, nan_rate=0.0)
    faulty = FaultyFabric(fab, schedule)
    cfg = session_config_from_args(args).replace(
        mesh={"shape": ()}, cache={"dir": None},
        probe={"n_probes": 4},
        solver={"budget": {"iters": iters, "chains": 4}})
    events: List[Dict[str, Any]] = []
    with Session(cfg) as s:
        s.attach(fab)
        s.plan()
        for _ in range(8):
            for ev in faulty.advance():
                timer = obs.tracer().timer("bench.recovery", kind=ev.kind)
                with timer:
                    if ev.kind == "node_preempt":
                        alive = s.alive
                        plan = s.on_node_leave(
                            [alive.index(b) for b in ev.nodes if b in alive])
                    else:
                        plan = s.on_node_join(
                            [b for b in ev.nodes if b not in s.alive])
                ms = timer.elapsed * 1e3
                ok = plan is not None and all(
                    e.expected_time <= e.best_identity_time * (1 + 1e-9)
                    and sorted(e.perm) == list(e.group)
                    for e in plan.entries.values())
                events.append({
                    "kind": ev.kind, "survivors": len(s.alive),
                    "recovery_ms": round(ms, 2),
                    "rungs": sorted(set(
                        (plan.meta.get("rungs") or {}).values()))
                    if plan is not None else [],
                    "ok": ok,
                })
                print(f"bench_faults,{ev.kind},{ms * 1e3:.0f},"
                      f"survivors={len(s.alive)}")
        health = s.health
    payload = {"bench": "session_faults", "smoke": bool(args.smoke),
               "n": n, "seed": args.seed, "health": health,
               "events": events}
    print(json.dumps(payload, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[bench] wrote {args.out}")
    if not events or not all(e["ok"] for e in events):
        print("[bench] FAIL: a churn recovery lost the plan or served "
              "an order worse than identity")
        return 1
    return 0


def run_obs_scenario(smoke: bool = True, seed: int = 0,
                     window_s: float = 1.0) -> Dict[str, Any]:
    """The obs benchmark scenario (CLI ``bench --scenario obs`` and
    the reference's ``benchmarks/obs_trace.py`` share this).

    Two measurements:

    * **tracing overhead** — median wall time of the same
      ``PlanCompiler.compile`` with the tracer disabled vs enabled
      (the disabled path must be a no-op: ``span()`` returns the
      shared null span); unlike the reference, after a warm-up compile,
      the two modes are timed in turns with the cyclic GC off, 15 pairs
      under ``smoke`` (27 otherwise; the reference times 5 / 9 calls a
      mode), and the overhead is the median of the pairs' ratios
      (``disabled_s`` and ``enabled_s`` stay each mode's median);
    * **capture → replay** — price a synthetic bursty trace under the
      single declared-mix plan (one operator-declared payload size, see
      :func:`repro_torch.obs.declared_mix`) vs per-phase-window plans
      compiled from :func:`repro_torch.obs.fold` output.  Phase-aware
      planning must not lose to the stationary plan.
    """
    import gc
    import statistics

    from repro_torch.fabric import make_datacenter, probe_fabric, scramble
    from repro_torch.obs import declared_mix, fold, replay, synthetic_bursty_trace
    from repro_torch.plan import PlanCompiler, SolveBudget

    n = 16 if smoke else 32
    iters = 60 if smoke else 200
    # three times the reference's 5 / 9: at 5 calls a mode a card's host
    # read 10 % or more in 3 to 11 trials of 60, whichever way it was
    # timed, and at 15 pairs in none (tools/obs_gate_spread.py)
    reps = 15 if smoke else 27
    fab, _ = scramble(make_datacenter(n, seed=seed), seed=seed + 1)
    probe = probe_fabric(fab, seed=seed)
    compiler = PlanCompiler(budget=SolveBudget(iters=iters, chains=2))

    trace = synthetic_bursty_trace(n, seed=seed)
    stationary_mix = declared_mix(trace)

    tr = obs.tracer()
    was_enabled = tr.enabled
    samples: Dict[str, List[float]] = {"disabled": [], "enabled": []}
    # after one untimed compile, the two modes in turns (each pair in the
    # other order than the last), with the cyclic GC off as ``timeit``
    # times, and the overhead read as the median of the pairs' ratios: a
    # host's calls run fast or slow in stretches of several calls, and one
    # such stretch (or a GC pass over a large heap) landing in one mode's
    # block of the reference's block-by-block timing moves that mode's
    # median past the gate; a pair's two calls share their stretch
    # (tools/obs_gate_spread.py reads it each way)
    modes = (("disabled", False), ("enabled", True))
    gc_was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        tr.set_enabled(False)
        compiler.compile(probe, stationary_mix)
        for rep in range(reps):
            for mode, enable in modes[::1 if rep % 2 == 0 else -1]:
                tr.set_enabled(enable)
                t = tr.timer("bench.obs.compile")   # measures even when off
                with t:
                    compiler.compile(probe, stationary_mix)
                samples[mode].append(t.elapsed)
    finally:
        tr.set_enabled(was_enabled)
        if gc_was_enabled:
            gc.enable()
    timings = {mode: statistics.median(v) for mode, v in samples.items()}
    overhead_pct = (statistics.median(
        on / max(off, 1e-12)
        for on, off in zip(samples["enabled"], samples["disabled"]))
        - 1.0) * 100.0

    declared_plan = compiler.compile(probe, stationary_mix)
    windows = fold(trace, window_s=window_s)
    phased = [(w, compiler.compile(probe, w.mix)) for w in windows]
    base = replay(trace, declared_plan, probe.lat, probe.bw)
    ph = replay(trace, declared_plan, probe.lat, probe.bw, windows=phased)
    return {
        "bench": "obs",
        "smoke": bool(smoke),
        "n": n,
        "seed": seed,
        "compile": {
            "disabled_s": round(timings["disabled"], 6),
            "enabled_s": round(timings["enabled"], 6),
            "overhead_pct": round(overhead_pct, 3),
            "reps": reps,
        },
        "replay": {
            "trace": trace.name,
            "records": len(trace),
            "windows": len(windows),
            "declared_s": base["total_seconds"],
            "phased_s": ph["total_seconds"],
            "phased_beats_declared":
                ph["total_seconds"] <= base["total_seconds"],
            "unplanned": base["unplanned"] + ph["unplanned"],
        },
    }


def cmd_bench_obs(args: argparse.Namespace) -> int:
    """Observability scenario: tracing-overhead gate + capture→replay.

    Fails (exit 1) if enabled-tracer overhead exceeds 10% (CI noise
    headroom over the reference's 2% budget) or if the phase-windowed
    plans lose to the single declared-mix plan."""
    payload = run_obs_scenario(smoke=bool(args.smoke), seed=args.seed)
    print(json.dumps(payload, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[bench] wrote {args.out}")
    if payload["compile"]["overhead_pct"] >= 10.0:
        print("[bench] FAIL: enabled-tracer overhead "
              f"{payload['compile']['overhead_pct']:.1f}% >= 10%")
        return 1
    if not payload["replay"]["phased_beats_declared"]:
        print("[bench] FAIL: phase-windowed plans lost to the single "
              "declared-mix plan on the bursty trace")
        return 1
    return 0


def cmd_bench_overlap(args: argparse.Namespace) -> int:
    """Overlap scenario: planned+bucketed vs planned-sequential step.

    Runs :mod:`repro_torch.bench.overlap_step` (the modeled-fabric
    pipeline gate + the 8-rank virtual-mesh step on ``--device``); fails
    (exit 1) when the bucketed step models under the 1.15x floor, the
    overlapped loss diverges from the baseline, or the certified
    schedule's postcondition breaks.  Refuses to start without CUDA
    unless ``--device cpu`` is given."""
    from repro_torch import resolve_device
    from repro_torch.bench import overlap_step

    device = resolve_device(args.device)
    try:
        overlap_step.run(smoke=bool(args.smoke), out_path=args.out,
                         seed=args.seed, device=device)
    except RuntimeError as e:
        print(f"[bench] FAIL: {e}")
        return 1
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    """Self-contained plan-pipeline benchmark (CI smoke + local sanity).

    Times, per fabric size: cold compile, warm cache hit, and the plan's
    expected speedup over the identity order — through the same Session
    facade applications use.

    ``--scenario faults`` switches to the churn/recovery scenario
    (:func:`cmd_bench_faults`); ``--scenario obs`` to the observability
    overhead + capture→replay scenario (:func:`cmd_bench_obs`);
    ``--scenario overlap`` to the overlapped-train-step gate
    (:func:`cmd_bench_overlap`).
    """
    from repro_torch.session import Session

    if getattr(args, "scenario", "plan") == "faults":
        return cmd_bench_faults(args)
    if getattr(args, "scenario", "plan") == "obs":
        return cmd_bench_obs(args)
    if getattr(args, "scenario", "plan") == "overlap":
        return cmd_bench_overlap(args)
    sizes = [16] if args.smoke else [32, 64]
    iters = 200 if args.smoke else 800
    results: List[Dict[str, Any]] = []
    for n in sizes:
        cfg = session_config_from_args(args)
        cfg = cfg.replace(
            fabric={"kind": "datacenter", "nodes": n, "scramble_seed": 1},
            mesh={"shape": ()},
            cache={"dir": None},
            solver={"budget": {"iters": iters, "chains": 4}})
        with Session(cfg) as s:
            cold = obs.tracer().timer("bench.cold_compile", n=n)
            with cold:
                plan = s.plan()
            cold_s = cold.elapsed
            warm = obs.tracer().timer("bench.warm_hit", n=n)
            with warm:
                s.service.request(s.probe, s.mix)    # warm: LRU probe
            warm_s = warm.elapsed
            speedups = [
                e.best_identity_time / max(e.expected_time, 1e-30)
                for e in plan.entries.values()
            ]
            row = {
                "n": n,
                "entries": len(plan.entries),
                "cold_compile_s": round(cold_s, 4),
                "warm_hit_s": round(warm_s, 6),
                "warm_speedup_x": round(cold_s / max(warm_s, 1e-9), 1),
                "mean_speedup_vs_identity":
                    round(sum(speedups) / len(speedups), 3),
                "cache_hits": s.service.stats["cache_hits"],
            }
        results.append(row)
        print(f"bench,n={n},{row['cold_compile_s'] * 1e6:.0f},"
              f"warm_x={row['warm_speedup_x']}")
    payload = {"bench": "session_plan", "smoke": bool(args.smoke),
               "results": results}
    print(json.dumps(payload, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[bench] wrote {args.out}")
    for row in results:
        if row["cache_hits"] < 1:
            print("[bench] FAIL: warm request missed the plan cache")
            return 1
    return 0


# ---------------------------------------------------------------------------
# status / trace
# ---------------------------------------------------------------------------

def cmd_status(args: argparse.Namespace) -> int:
    """Print the process obs-metrics snapshot (JSON or Prometheus text).

    By default a small dry-run session (attach + plan, no cache writes)
    is driven first so the snapshot reflects a live pipeline; pass
    ``--no-run`` to dump whatever the process has already recorded.
    """
    cfg = session_config_from_args(args)
    if _maybe_dump(args, cfg):
        return 0
    if not args.no_run:
        from repro_torch.session import Session

        run_cfg = cfg.replace(
            mesh={"shape": ()}, cache={"dir": None},
            **({} if args.iters is not None
               else {"solver": {"budget": {"iters": 60, "chains": 2}}}))
        with Session(run_cfg) as s:
            s.attach()
            s.plan()
    m = obs.metrics()
    if args.format == "prom":
        sys.stdout.write(m.to_prometheus())
    else:
        print(json.dumps(m.snapshot(), indent=1))
    return 0


def cmd_trace_export(args: argparse.Namespace) -> int:
    """Run the planning pipeline under the tracer, export Chrome JSON.

    The artifact loads in ``chrome://tracing`` and https://ui.perfetto.dev.
    """
    cfg = session_config_from_args(args)
    if _maybe_dump(args, cfg):
        return 0
    from repro_torch.session import Session

    tr = obs.tracer()
    tr.set_enabled(True)
    run_cfg = cfg.replace(
        mesh={"shape": ()}, cache={"dir": None},
        **({} if args.iters is not None
           else {"solver": {"budget": {"iters": 60, "chains": 2}}}))
    with Session(run_cfg) as s:
        s.attach()
        s.plan()
    n_events = tr.export(args.out)
    print(f"[trace] wrote {n_events} events to {args.out} "
          f"(open in chrome://tracing or ui.perfetto.dev)")
    return 0


def cmd_trace_replay(args: argparse.Namespace) -> int:
    """Replay a captured (or synthetic bursty) workload trace.

    Compares the single declared-mix plan against per-phase-window
    plans compiled from the folded trace; prints both totals.
    """
    from repro_torch.fabric import make_datacenter, probe_fabric, scramble
    from repro_torch.obs import (WorkloadTrace, declared_mix, fold, replay,
                           synthetic_bursty_trace)
    from repro_torch.plan import PlanCompiler, SolveBudget

    if args.trace:
        trace = WorkloadTrace.load(args.trace)
        n = int(trace.meta.get("n", args.nodes or 16))
    else:
        n = args.nodes or 16          # session-args --nodes, default 16
        trace = synthetic_bursty_trace(n, seed=args.seed)
    if not len(trace):
        print("[trace] empty trace: nothing to replay")
        return 1
    fab, _ = scramble(make_datacenter(n, seed=args.seed),
                      seed=args.seed + 1)
    probe = probe_fabric(fab, seed=args.seed)
    compiler = PlanCompiler(
        budget=SolveBudget(iters=args.iters or 200, chains=2))
    declared_plan = compiler.compile(probe, declared_mix(trace))
    windows = fold(trace, window_s=args.window)
    phased = [(w, compiler.compile(probe, w.mix)) for w in windows]
    base = replay(trace, declared_plan, probe.lat, probe.bw)
    ph = replay(trace, declared_plan, probe.lat, probe.bw, windows=phased)
    print(f"[trace] replay {trace.name}: {len(trace)} records, "
          f"{len(windows)} phase windows (window={args.window}s), n={n}")
    print(f"  declared-mix plan : {base['total_seconds'] * 1e3:.3f}ms "
          f"({base['unplanned']} unplanned)")
    print(f"  phase-window plans: {ph['total_seconds'] * 1e3:.3f}ms "
          f"({ph['unplanned']} unplanned)")
    win = base["total_seconds"] / max(ph["total_seconds"], 1e-30)
    print(f"  phased vs declared: {win:.4f}x")
    if args.out:
        payload = {"trace": trace.name, "n": n, "windows": len(windows),
                   "declared": base, "phased": ph}
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[trace] wrote {args.out}")
    return 0


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------

def _analyze_sweep(n_list, fabric_nodes, seed):
    """Verify the full builder catalogue; returns (reports, n_bad)."""
    import random

    from repro_torch.collective import (
        CollectiveOp, apply_permutation, chunk, compile_op, get_builder,
        registered_builders)
    from repro_torch.collective.builders import candidates
    from repro_torch.analysis import verify_program

    fab = None
    if fabric_nodes:
        from repro_torch.fabric import make_datacenter
        fab = make_datacenter(fabric_nodes, seed=seed)
    reports = []
    n_bad = 0
    for algo in sorted(registered_builders()):
        b = get_builder(algo)
        for kind in b.kinds:
            for n in n_list:
                # candidates() supplies the feasible kwarg sets (e.g.
                # every valid bcube base at this n)
                akws = [akw for a, akw in candidates(kind, n) if a == algo]
                op = CollectiveOp(kind=kind, size_bytes=1 << 20,
                                  group=tuple(range(n)))
                for akw in akws:
                    base = compile_op(op, algo, **dict(akw))
                    rng = random.Random(seed + n)
                    perm = list(range(n))
                    rng.shuffle(perm)
                    variants = (("identity", base),
                                ("permuted", apply_permutation(base, perm)),
                                ("chunked", chunk(base, 4)))
                    for label, prog in variants:
                        use_fab = fab if fab is not None and \
                            fab.n == prog.n else None
                        rep = verify_program(prog, fabric=use_fab)
                        reports.append((label, rep))
                        if not rep.clean:
                            n_bad += 1
    return reports, n_bad


def _equiv_sweep(n_list, seed):
    """Differential translation validation over the builder catalogue.

    Every registered builder × kind × n is lowered and bisimulated at
    each rewrite stage (base → apply_permutation → chunk →
    fuse_rounds).  Returns (rows, n_bad) where each row is one
    program's stage-by-stage verdict list.
    """
    import random

    from repro_torch.collective import CollectiveOp, compile_op, get_builder, \
        registered_builders
    from repro_torch.collective.builders import candidates
    from repro_torch.analysis import certify_stages

    rows = []
    n_bad = 0
    for algo in sorted(registered_builders()):
        b = get_builder(algo)
        for kind in b.kinds:
            for n in n_list:
                akws = [akw for a, akw in candidates(kind, n) if a == algo]
                op = CollectiveOp(kind=kind, size_bytes=1 << 20,
                                  group=tuple(range(n)))
                for akw in akws:
                    prog = compile_op(op, algo, **dict(akw))
                    rng = random.Random(seed + n)
                    perm = list(range(n))
                    rng.shuffle(perm)
                    stages = certify_stages(prog, perm=perm, chunk_k=4)
                    ok = all(s["ok"] for s in stages)
                    if not ok:
                        n_bad += 1
                    rows.append({
                        "algorithm": algo, "kind": kind, "n": n,
                        "algo_kwargs": dict(akw), "ok": ok,
                        "stages": stages,
                    })
    return rows, n_bad


def cmd_analyze(args: argparse.Namespace) -> int:
    """Static analysis: lint the repo, or verify collective Programs."""
    if args.lint:
        from repro_torch.analysis.lint import RULES, lint_repo

        root = args.root or os.getcwd()
        findings, n_files = lint_repo(root)
        for f in findings:
            print(f)
        verdict = "clean" if not findings else f"{len(findings)} finding(s)"
        print(f"[lint] {n_files} files, {len(RULES)} rules: {verdict}")
        return 1 if findings else 0

    if args.equiv:
        n_list = [int(x) for x in args.n_list.split(",")]
        rows, n_bad = _equiv_sweep(n_list, args.seed)
        for row in rows:
            if row["ok"]:
                continue
            for st in row["stages"]:
                if st["ok"]:
                    continue
                print(f"  FAIL {row['algorithm']}/{row['kind']} "
                      f"n={row['n']} stage={st['stage']} "
                      f"codes={sorted(st['codes'])}")
        by_algo: Dict[str, int] = {}
        for row in rows:
            by_algo.setdefault(row["algorithm"], 0)
            if not row["ok"]:
                by_algo[row["algorithm"]] += 1
        for algo in sorted(by_algo):
            total = sum(1 for r in rows if r["algorithm"] == algo)
            state = "CERTIFIED" if not by_algo[algo] \
                else f"{by_algo[algo]} FAILING"
            print(f"  {algo:<22} {total:>3} programs  {state}")
        print(f"[analyze] equiv: {len(rows)} programs x "
              f"{len(rows[0]['stages']) if rows else 0} stages, "
              f"{n_bad} failing")
        if args.out:
            payload = {"n_programs": len(rows), "n_bad": n_bad,
                       "n_list": n_list, "rows": rows}
            with open(args.out, "w") as f:
                json.dump(payload, f, indent=1)
            print(f"[analyze] wrote {args.out}")
        return 1 if n_bad else 0

    if args.program:
        from repro_torch.collective import CollectiveOp, compile_op, get_builder
        from repro_torch.analysis import verify_program

        algo = args.program
        b = get_builder(algo)
        n = args.nodes or 16
        if not b.feasible(n):
            print(f"[analyze] {algo} is infeasible at n={n}")
            return 1
        fab = None
        if args.fabric_nodes:
            from repro_torch.fabric import make_datacenter
            fab = make_datacenter(n, seed=args.seed)
        bad = 0
        for kind in b.kinds:
            op = CollectiveOp(kind=kind, size_bytes=args.payload_bytes
                              or (1 << 20), group=tuple(range(n)))
            rep = verify_program(compile_op(op, algo), fabric=fab)
            print(rep.describe())
            bad += 0 if rep.ok else 1
        return 1 if bad else 0

    if args.plan:
        from repro_torch.session import Session
        from repro_torch.analysis import verify_program

        cfg = session_config_from_args(args)
        if _maybe_dump(args, cfg):
            return 0
        bad = 0
        with Session(cfg) as s:
            plan = s.plan()
            fab = s._oracle_fabric
            for (op, bucket, group), e in sorted(plan.entries.items()):
                prog = e.program()
                use_fab = fab if fab is not None and fab.n >= max(group) + 1 \
                    else None
                rep = verify_program(prog, fabric=use_fab)
                print(f"  {op:<15} bucket=2^{bucket:<3} "
                      f"group={len(group):>4} {rep.summary()}")
                bad += 0 if rep.ok else 1
        print(f"[analyze] plan: {bad} failing entr{'y' if bad == 1 else 'ies'}"
              if bad else "[analyze] plan: all entries verified")
        return 1 if bad else 0

    # default: full-catalogue sweep
    n_list = [int(x) for x in args.n_list.split(",")]
    reports, n_bad = _analyze_sweep(n_list, args.fabric_nodes, args.seed)
    by_algo: Dict[str, int] = {}
    for label, rep in reports:
        by_algo[rep.algorithm] = by_algo.get(rep.algorithm, 0)
        if not rep.clean:
            by_algo[rep.algorithm] += 1
            print(rep.describe())
    for algo in sorted(by_algo):
        n_variants = sum(1 for _, r in reports if r.algorithm == algo)
        state = "CLEAN" if not by_algo[algo] else f"{by_algo[algo]} DIRTY"
        print(f"  {algo:<22} {n_variants:>3} variants  {state}")
    print(f"[analyze] {len(reports)} programs verified, "
          f"{n_bad} with errors/warnings")
    if args.out:
        payload = {
            "n_programs": len(reports),
            "n_bad": n_bad,
            "n_list": n_list,
            "reports": [dict(variant=label, **rep.to_dict())
                        for label, rep in reports],
        }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[analyze] wrote {args.out}")
    return 1 if n_bad else 0


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    from repro_torch import __version__

    ap = argparse.ArgumentParser(prog="python -m repro_torch",
                                 description="PyTorch/CUDA port of repro: "
                                             "probe, plan, train, serve, bench")
    ap.add_argument("--version", action="version",
                    version=f"repro_torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("probe", help="probe a fabric, print/export the result")
    _add_session_args(p)
    p.add_argument("--out", default=None, help="write probe JSON here")
    p.set_defaults(fn=cmd_probe)

    p = sub.add_parser("plan", help="compile (or fetch) a collective plan")
    _add_session_args(p)
    p.add_argument("--dry-run", action="store_true",
                   help="compile + report without touching the plan store")
    p.add_argument("--out", default=None, help="write the plan JSON here")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("train", help="train over a planned (reordered) "
                                     "virtual data-parallel mesh")
    _add_session_args(p)
    p.add_argument("--arch", default="qwen2-0.5b")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8,
                   help="global batch rows, split over the mesh's ranks")
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--reorder", choices=["none", "simulate", "probe"],
                   default="simulate",
                   help="simulate: plan on a scrambled simulated fabric; "
                        "none: a certified ring at the identity order; "
                        "probe: live probes (not ported yet: raises)")
    p.add_argument("--smoke", action="store_true",
                   help="the reduced same-family config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    p.add_argument("--lr", type=float, default=1e-3)
    p.set_defaults(fn=cmd_train, mesh_default="1")

    p = sub.add_parser("serve", help="batched generation on one device, "
                                     "with the serving mix's plan")
    _add_session_args(p)
    p.add_argument("--arch", default="qwen2-0.5b")
    p.add_argument("--attention-impl", choices=["xla", "flash"], default="flash",
                   help="attention families: flash: the flash-attention CUDA "
                        "kernel for the prefill; xla: plain grouped attention "
                        "(the reference's name)")
    p.add_argument("--wkv-impl", choices=["xla", "kernel"], default="kernel",
                   help="rwkv6: kernel: chunked CUDA WKV kernel for the "
                        "prefill; xla: the exact recurrence (the reference's "
                        "name)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--smoke", action="store_true",
                   help="the reduced same-family config")
    p.add_argument("--reorder", choices=["none", "simulate", "probe"],
                   default="simulate",
                   help="simulate: plan the serving mix on a scrambled "
                        "simulated fabric over --mesh; none: no plan; probe: "
                        "live probes (not ported yet: raises)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--seed", type=int, default=0, help="weight seed")
    p.set_defaults(fn=cmd_serve, mesh_default="1")

    p = sub.add_parser("bench", help="session/plan pipeline benchmark")
    _add_session_args(p)
    p.add_argument("--smoke", action="store_true",
                   help="one small fabric (CI)")
    p.add_argument("--scenario", default="plan",
                   choices=["plan", "faults", "obs", "overlap"],
                   help="plan: compile/cache pipeline; faults: seeded "
                        "churn with ladder recovery; obs: tracing "
                        "overhead + capture/replay; overlap: bucketed "
                        "overlapped train step vs sequential")
    p.add_argument("--seed", type=int, default=0,
                   help="scenario seed (faults schedule / obs trace)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where --scenario overlap runs its train steps (the "
                        "other scenarios are host-only)")
    p.add_argument("--out", default=None, help="write bench JSON here")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("analyze",
                       help="static analysis: verify Programs / lint repo")
    _add_session_args(p)
    p.add_argument("--lint", action="store_true",
                   help="run the repo's AST lint gate instead of the "
                        "program verifier")
    p.add_argument("--root", default=None,
                   help="repo root for --lint (default: cwd)")
    p.add_argument("--program", default=None, metavar="ALGO",
                   help="verify one registered builder's program")
    p.add_argument("--plan", action="store_true",
                   help="verify every entry of the session's plan")
    p.add_argument("--equiv", action="store_true",
                   help="differential translation validation: lower + "
                        "bisimulate every builder at each rewrite stage")
    p.add_argument("--n-list", default="4,8,16,64",
                   help="sweep group sizes (default: 4,8,16,64)")
    p.add_argument("--fabric-nodes", type=int, default=None,
                   help="attach a synthetic datacenter fabric of this "
                        "size for the contention pass")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="write the verification report JSON here")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("status",
                       help="obs metrics snapshot (json or prometheus)")
    _add_session_args(p)
    p.add_argument("--format", default="json", choices=["json", "prom"])
    p.add_argument("--no-run", action="store_true",
                   help="skip the dry-run pipeline; dump current metrics")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("trace", help="export or replay obs traces")
    tsub = p.add_subparsers(dest="trace_cmd", required=True)

    t = tsub.add_parser("export",
                        help="run the pipeline traced, write Chrome JSON")
    _add_session_args(t)
    t.add_argument("--out", default="trace.json",
                   help="Chrome trace-event JSON path")
    t.set_defaults(fn=cmd_trace_export)

    t = tsub.add_parser("replay",
                        help="replay a captured/synthetic workload trace")
    _add_session_args(t)
    t.add_argument("--trace", default=None,
                   help="WorkloadTrace JSON (default: synthetic bursty)")
    t.add_argument("--window", type=float, default=1.0,
                   help="fold window seconds")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--out", default=None, help="write comparison JSON here")
    t.set_defaults(fn=cmd_trace_replay)

    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # train/serve build meshes: give --mesh a launcher default of one rank
    if getattr(args, "mesh", None) is None and hasattr(args, "mesh_default"):
        args.mesh = args.mesh_default
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
