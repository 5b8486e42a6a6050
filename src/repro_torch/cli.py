"""``python -m repro_torch``: the port's command-line interface.

Counterpart of ``repro``'s CLI (``repro/cli.py``) for four subcommands::

    python -m repro_torch probe --fabric datacenter --nodes 64
    python -m repro_torch plan  --mesh 8 --payload-bytes 988065536 --dry-run
    python -m repro_torch train --arch qwen2-0.5b --mesh 8 --batch 16 \\
        --seq 1024 --steps 4 --reorder simulate
    python -m repro_torch serve --arch glm4-9b --batch 8 --prompt-len 2048

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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

__all__ = ["main", "build_parser", "session_config_from_args"]

#: the reducer's bucket payload when no plan supplies one (``--reorder none``)
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024
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
                   help="jax raises: the port's solver runs numpy only")
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


def cmd_train(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from repro_torch import obs, resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import (
        apply_planned, make_mesh, parse_mesh, planning_session)
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (
        OverlapGradReducer, Trainer, TrainerConfig, certified_allreduce,
        init_state, make_overlap_train_step, make_train_step, partition_tree)
    from repro_torch.tree import tree_leaves

    cfg = session_config_from_args(args, workload="train")
    if _maybe_dump(args, cfg):
        return 0
    device = resolve_device(args.device)
    shape, axes = parse_mesh(args.mesh)
    others = [a for a, s in zip(axes, shape) if a != "data" and s > 1]
    if others:
        raise NotImplementedError(
            f"mesh axes {others} shard the model, which waits for the "
            f"sharding port (ROADMAP.md §1 item 11); train over a "
            f"data-parallel mesh such as --mesh {int(np.prod(shape))}")
    n = int(np.prod(shape))
    if args.batch % n:
        raise ValueError(f"--batch {args.batch} does not split over the "
                         f"{n} data-parallel ranks of --mesh {args.mesh}")

    arch = get_config(args.arch)
    if arch.n_experts:
        # the virtual-mesh trainer stacks every rank's gradients: for one
        # full-width deepseek-v2 MoE layer that alone is 8 x 7.6 GB
        raise NotImplementedError(
            f"train does not take {arch.name} ({arch.family!r}) yet: MoE "
            f"training on the card waits for the sharding specs, ROADMAP.md "
            f"§1 item 18 (behind item 11); its loss and gradients are held "
            f"to the reference's on the CPU")
    if arch.family == "encdec":
        # the reference's train builds batches of tokens and labels only
        # (host_batch), and WhisperLM.loss reads batch["frontend_embeds"]
        raise NotImplementedError(
            f"train has no audio batches for {arch.name} ({arch.family!r}): "
            f"its loss needs the encoder's frontend_embeds, which the "
            f"synthetic data does not carry (the reference's train fails on "
            f"the same missing key)")
    if args.smoke:
        arch = dataclasses.replace(arch.smoke(), vocab_size=2048)
    model = get_model(arch, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_state(model, gen)
    grad_bytes = float(sum(t.numel() * t.element_size()
                           for t in tree_leaves(state.params)))
    if not _payload_given(args):
        # plan the all-reduce this model's gradients actually need
        cfg = cfg.replace(payload_bytes=grad_bytes)

    transport = "peer_ring" if device.type == "cuda" else "runner"
    mode = cfg.overlap.mode if cfg.overlap.mode != "off" else "bucketed"
    session = planning_session(args, session_config=cfg)
    if session is None:
        mesh, plan, reducer = make_mesh(shape, axes, device), None, None
    else:
        with session:
            applied = apply_planned(session, device=device)
            mesh, plan = applied.mesh, applied.plan
            reducer = session.overlap_step(total_bytes=grad_bytes, mode=mode,
                                           transport=transport)
    if reducer is None and n > 1:
        reducer = OverlapGradReducer(
            certified_allreduce(n, DEFAULT_BUCKET_BYTES, "ring"),
            bucket_bytes=DEFAULT_BUCKET_BYTES, mode=mode,
            use_kernel_add=cfg.overlap.use_kernel_add, transport=transport)
    opt = AdamWConfig(schedule=train_schedule(args.lr, args.steps))
    if reducer is None:
        step_fn = make_train_step(model, opt)    # one rank: no all-reduce
        print(f"[train] {arch.name} on {device}: one rank, no all-reduce")
    else:
        if reducer.n != n:
            raise ValueError(f"the plan's all-reduce spans {reducer.n} "
                             f"ranks, the mesh {n}")
        buckets = partition_tree(state.params, reducer.bucket_bytes)
        print(f"[train] {arch.name} on {device}: {n} data-parallel ranks x "
              f"{args.batch // n} x {args.seq} tokens; all-reduce "
              f"{reducer.schedule.algorithm} order "
              f"{list(reducer.schedule.order)}, {len(buckets)} buckets of "
              f"{reducer.bucket_bytes:.0f} bytes, transport "
              f"{reducer.transport}")
        step_fn = make_overlap_train_step(model, opt, reducer)
    ds = SyntheticLM(arch.vocab_size, args.seq, args.batch, seed=0)
    rows = mesh.batch_rows(args.batch)   # data shard i on rank mesh.order[i]

    def batches():
        i = 0
        while True:
            yield ds.batch_rows(i, rows)
            i += 1

    trainer = Trainer(
        step_fn=step_fn, state=state, batches=batches(),
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
    ck = report["checkpoint"]
    print(f"[train] arch={arch.name} steps={report['final_step']} "
          f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} in "
          f"{timer.elapsed:.2f}s; checkpoint step {ck['step']} "
          f"{ck['bytes']} bytes (snapshot {ck['snapshot_s']:.2f}s, write "
          f"{ck['write_s']:.2f}s)")
    summary = {
        "arch": arch.name, "device": str(device), "ranks": n,
        "batch": args.batch, "seq": args.seq,
        "steps": report["final_step"],
        "losses": [row["loss"] for row in h],
        "step_s": [row["sec"] for row in h],
        "plan_digest": plan.fingerprint.digest if plan is not None else None,
        "mesh_order": list(mesh.order), "checkpoint": ck,
    }
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

    from repro_torch import obs, resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch import build_mesh
    from repro_torch.models import get_model
    from repro_torch.parallel.moe_a2a import arm_ep, clear_ep
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
    arch = dataclasses.replace(arch, wkv_impl=args.wkv_impl,
                               attention_impl=args.attention_impl)
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
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    # the EP half of the reference's configure_sp: an MoE arch on a mesh
    # whose data axis has more than one rank runs its prompts' experts
    # through the EP all-to-all, in the plan's order
    armed = bool(arch.n_experts) and sizes.get("data", 1) > 1
    if armed:
        arm_ep(mesh, "data", "model" if sizes.get("model", 1) > 1 else None,
               plan=plan)
    timer = obs.tracer().timer("cli.serve.generate", batch=args.batch)
    try:
        with timer:
            # ends on a host copy: synchronised
            outs = eng.generate(prompts, frontend_embeds=fe)
    finally:
        if armed:
            clear_ep()
    dt = max(timer.elapsed, 1e-9)
    total = sum(len(o) for o in outs)
    print(f"[serve] arch={arch.name} {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch",
                                 description="PyTorch/CUDA port of repro: "
                                             "probe, plan, train, serve")
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
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # train builds a mesh: give --mesh a launcher default of one rank
    if getattr(args, "mesh", None) is None and hasattr(args, "mesh_default"):
        args.mesh = args.mesh_default
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
