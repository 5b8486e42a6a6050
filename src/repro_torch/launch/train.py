"""The training launcher's ``build_mesh`` (counterpart of ``repro.launch.train``).

The user-facing entry point is::

    python -m repro_torch train --arch qwen2-0.5b --mesh 8 --steps 100 \\
        --reorder simulate            # probe + solve + planned mesh

:func:`planning_session` configures the :class:`repro_torch.session.Session`
that ``--reorder`` plans through, :func:`apply_planned` takes an open
one through probe → plan → apply, and :func:`build_mesh` does both and
returns the planned virtual mesh with the compiled plan.  The train
command keeps the session open past apply to build its reducer from
the plan (:meth:`~repro_torch.session.Session.overlap_step`).
``--reorder`` selects the policy:

* ``simulate`` — plan on a simulated, scrambled fabric (as the
  reference does);
* ``none`` — the identity order and no plan (also what a one-rank mesh
  gets): the train command then runs a certified ring at the identity
  order;
* ``probe`` — plan on live pairwise probes: raises until the device
  probe is ported (ROADMAP.md §1 item 13).

Unlike the reference, a mesh that cannot be built raises; training never
proceeds on an unreordered mesh in place of a planned one.

:func:`build_train_step` picks the step ``train`` runs on a mesh (the
data-parallel overlapped step, the tensor-parallel ZeRO-1 step, the EP
step or the data-parallel MoE step) with its reducer and its state,
and raises ``train``'s refusals (:func:`train_layout`); ``train`` and the
dry run (:mod:`repro_torch.launch.dryrun`) both call it.

``python -m repro_torch.launch.train`` and :func:`default_job_mix` remain
as the reference's deprecated shims over the CLI's ``train`` and
:func:`repro_torch.session.train_mix`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

__all__ = ["DEFAULT_BUCKET_BYTES", "TrainBuild", "apply_planned",
           "build_mesh", "build_train_step", "default_job_mix", "main",
           "parse_mesh", "planning_session", "train_layout"]

#: the reducer's bucket payload when no plan supplies one (``--reorder none``)
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024


def parse_mesh(s: str):
    """``"8"``, ``"2x4"`` or ``"2x16x16"`` → ``(dims, axis names)``."""
    dims = tuple(int(x) for x in s.split("x"))
    axes = ("pod", "data", "model")[-len(dims):] if len(dims) == 3 else (
        ("data", "model") if len(dims) == 2 else ("data",))
    return dims, axes


def default_job_mix(payload_bytes: float, moe: bool = False):
    """Deprecated: use :func:`repro_torch.session.train_mix`."""
    warnings.warn(
        "repro_torch.launch.train.default_job_mix is deprecated; use "
        "repro_torch.session.train_mix", DeprecationWarning, stacklevel=2)
    from repro_torch.session import train_mix

    return train_mix(payload_bytes, moe=moe)


def planning_session(args, moe: bool = False, session_config=None):
    """The :class:`~repro_torch.session.Session` ``args.reorder`` plans
    through, not yet opened; None for ``none`` or a one-rank mesh.

    ``simulate`` plans on a scrambled TPU-fleet fabric shaped like the
    mesh (or on the fabric the caller's ``session_config`` declares):
    per-collective algorithm, rank order and the N-D mesh assignment,
    cached under the fabric fingerprint.
    """
    from repro_torch.session import Session, SessionConfig
    from repro_torch.session.config import FabricConfig

    shape, axes = parse_mesh(args.mesh)
    if args.reorder == "none" or int(np.prod(shape)) == 1:
        return None
    if args.reorder == "probe":
        raise NotImplementedError(
            "--reorder probe plans on live pairwise probes of the devices, "
            "which waits for the device probe (ROADMAP.md §1 item 13); use "
            "--reorder simulate or --reorder none")
    if args.reorder != "simulate":
        raise ValueError(f"unknown --reorder {args.reorder!r}")
    base = session_config or SessionConfig()
    pods = shape[0] if len(shape) == 3 else 1
    if base.fabric != FabricConfig():
        fabric = {}          # the user declared a fabric: honor it
    else:
        fabric = {"kind": "tpu-fleet", "n_pods": max(pods, 1),
                  "pod_shape": (shape[-2], shape[-1]) if len(shape) >= 2
                  else (shape[-1], 1),
                  "scramble_seed": 0}
    cache_dir = getattr(args, "plan_cache_dir", None)
    payload = getattr(args, "payload_bytes", None)
    return Session(base.replace(
        fabric=fabric,
        mesh={"shape": shape, "axis_names": axes},
        cache={"dir": cache_dir if cache_dir is not None
               else base.cache.dir},
        payload_bytes=payload if payload is not None else base.payload_bytes,
        moe=moe or base.moe,
    ))


def apply_planned(session, mix=None, device: Any = "cuda"):
    """Plan (``mix`` overrides the planned collective histogram) and apply
    on an open session; prints the plan's line and returns the
    :class:`~repro_torch.session.AppliedPlan`."""
    plan = session.plan(mix=mix)
    applied = session.apply(device=device)
    hit = "cache hit" if session.service.stats["cache_hits"] else \
        f"compiled in {plan.compile_seconds:.2f}s"
    mp = plan.mesh_plan
    print(f"[launch] plan {plan.fingerprint.digest} ({hit}): "
          f"mesh identity {mp.baseline_cost:.5f} -> optimized {mp.cost:.5f} "
          f"({mp.baseline_cost / max(mp.cost, 1e-30):.2f}x), "
          f"{len(plan.entries)} collective entries; rank order "
          f"{list(applied.mesh.order)}")
    return applied


def build_mesh(args, mix=None, moe: bool = False, session_config=None,
               device: Any = "cuda"):
    """Mesh per ``args.reorder``: ``none`` | ``simulate`` | ``probe``.

    Runs the Session lifecycle of :func:`planning_session` through
    :func:`apply_planned` (the planned mesh on ``device``).  Returns
    ``(mesh, plan)``: a :class:`~repro_torch.launch.mesh.PlannedMesh` and
    a :class:`repro_torch.plan.Plan` (None when reordering is off).
    """
    from repro_torch.launch.mesh import make_mesh

    session = planning_session(args, moe=moe, session_config=session_config)
    if session is None:
        return make_mesh(*parse_mesh(args.mesh), device), None
    with session:
        applied = apply_planned(session, mix=mix, device=device)
    return applied.mesh, applied.plan


def train_layout(arch, shape: Sequence[int], axes: Sequence[str],
                 batch: Optional[int] = None) -> Dict[str, Any]:
    """The layout ``train`` runs ``arch`` in on a mesh of ``shape`` over
    ``axes``: ``m`` (the model axis), ``dp`` (the data-parallel ranks),
    ``n`` (all ranks), ``moe`` (an MoE arch on 2 or more data ranks) and
    ``ep`` (the data axis divides the experts, so EP arms).  Raises what
    ``train`` refuses: a ``batch`` that does not split over the data
    ranks, MoE on a pod axis (ROADMAP.md §1 item 24), ``encdec``, and a
    family a model axis cannot shard (``require_tp_family``)."""
    from repro_torch.parallel.tensor import require_tp_family

    sizes = dict(zip(axes, shape))
    n = int(np.prod(shape))
    m = sizes.get("model", 1)
    dp = n // m
    if batch is not None and batch % dp:
        mesh = "x".join(str(s) for s in shape)
        raise ValueError(f"--batch {batch} does not split over the "
                         f"{dp} data-parallel ranks of --mesh {mesh}")
    moe = bool(arch.n_experts) and dp > 1
    if arch.n_experts and sizes.get("pod", 1) > 1:
        raise NotImplementedError(
            f"train {arch.name} ({arch.family!r}) on a pod axis: the experts "
            f"are replicated over pods, so their gradients need a pod-axis "
            f"all-reduce of their own, ROADMAP.md §1 item 24")
    if arch.family == "encdec":
        # the reference's train builds batches of tokens and labels only
        # (host_batch), and WhisperLM.loss reads batch["frontend_embeds"]
        raise NotImplementedError(
            f"train has no audio batches for {arch.name} ({arch.family!r}): "
            f"its loss needs the encoder's frontend_embeds, which the "
            f"synthetic data does not carry (the reference's train fails on "
            f"the same missing key)")
    if m > 1:
        require_tp_family(arch)
    # EP arms where the data axis divides the experts; elsewhere the
    # reference's ep_armed is false and its moe_layer runs moe_dense
    return {"m": m, "dp": dp, "n": n, "moe": moe,
            "ep": moe and arch.n_experts % dp == 0}


@dataclasses.dataclass
class TrainBuild:
    """The step ``train`` runs on a mesh (:func:`build_train_step`).

    ``kind`` is ``one_rank`` (no all-reduce), ``data_parallel`` (the
    overlapped step), ``tensor_parallel`` (the ZeRO-1 step), ``ep`` or
    ``dense_moe``; ``sharded`` is the step object of the last three
    (``counts``, ``layout``), else None; ``memory`` the data-parallel MoE
    step's reckoning.  The batch a step takes is
    :func:`repro_torch.data.synthetic.make_global_batch`'s ``[n, rows,
    S]`` for a sharded step, the host batch's rows in mesh order
    (:meth:`PlannedMesh.batch_rows`) otherwise (``global_batch``)."""

    kind: str
    step: Callable
    model: Any
    mesh: Any
    reducer: Any
    sharded: Any
    layout: Dict[str, Any]
    memory: Optional[Dict[str, int]] = None

    @property
    def global_batch(self) -> bool:
        return self.sharded is not None

    def state(self, generator=None):
        """The step's state: parameters drawn from ``generator``, or with
        none, ``meta`` stand-ins of the same shapes, dtypes and layout
        (the dry run's: nothing drawn, nothing allocated)."""
        import torch

        from repro_torch.optim import init_opt
        from repro_torch.train import init_state
        from repro_torch.train import sharded_step as ss
        from repro_torch.train.train_step import TrainState

        if self.sharded is not None:
            if generator is not None:
                return ss.init_sharded_state(self.model, generator,
                                             self.sharded.layout)
            return ss.layout_state(ss.param_shapes(self.model),
                                   self.sharded.layout)
        if generator is not None:
            return init_state(self.model, generator)
        params = ss.param_shapes(self.model)
        return TrainState(params, init_opt(params),
                          torch.zeros((), dtype=torch.int32, device="meta"))


def build_train_step(arch, mesh, device: Any = "cuda", *, model=None,
                     opt=None, plan=None, reducer=None,
                     bucket_bytes: float = DEFAULT_BUCKET_BYTES,
                     mode: str = "bucketed", use_kernel_add: bool = True,
                     card_bytes: Optional[int] = None,
                     log: Optional[Callable[[str], None]] = None
                     ) -> TrainBuild:
    """The step ``train`` runs for ``arch`` on ``mesh``.

    ``device`` is the card the kernels run on: it picks the data axis's
    transport (``peer_ring`` on CUDA, the runner elsewhere); ``model``
    (default ``get_model(arch, device)``) may hold its tensors elsewhere,
    as the dry run's on ``meta``.  ``reducer`` is the data axis's
    all-reduce where a plan made one; else a certified ring at the
    identity order (``bucket_bytes`` a bucket on a model axis or for MoE,
    :data:`DEFAULT_BUCKET_BYTES` on a data-parallel mesh).  An MoE arch
    whose data axis does not divide its experts runs the data-parallel
    MoE step: its memory is reckoned (``log`` gets ``train``'s lines) and
    a reckoning over ``card_bytes`` refuses the run.  Arms the SP/EP
    contexts (:func:`repro_torch.launch.specs.configure_sp`, in ``plan``'s
    all-to-all order); the caller clears them
    (``moe_a2a.clear_ep``, ``clear_sequence_parallel``).
    """
    import json

    from repro_torch import resolve_device
    from repro_torch.launch.specs import configure_sp
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (
        OverlapGradReducer, certified_allreduce, make_overlap_train_step,
        make_train_step)
    from repro_torch.train.sharded_step import (
        DenseMoETrainStep, make_ep_train_step, make_sharded_train_step,
        param_shapes, reckon_dense_moe_memory)

    lay = train_layout(arch, mesh.shape, mesh.axis_names)
    m, dp, n, moe, ep = (lay[k] for k in ("m", "dp", "n", "moe", "ep"))
    device = resolve_device(device)
    model = model if model is not None else get_model(arch, device=device)
    opt = opt if opt is not None else AdamWConfig()
    transport = "peer_ring" if device.type == "cuda" else "runner"
    if (m > 1 or moe) and dp > 1 and reducer is None:
        reducer = OverlapGradReducer(
            certified_allreduce(dp, bucket_bytes, "ring"),
            bucket_bytes=bucket_bytes, mode=mode,
            use_kernel_add=use_kernel_add, transport=transport)
    if reducer is None and m == 1 and n > 1:
        reducer = OverlapGradReducer(
            certified_allreduce(n, DEFAULT_BUCKET_BYTES, "ring"),
            bucket_bytes=DEFAULT_BUCKET_BYTES, mode=mode,
            use_kernel_add=use_kernel_add, transport=transport)
    memory = None
    if moe and not ep:
        memory = reckon_dense_moe_memory(param_shapes(model), dp,
                                         reducer.bucket_bytes)
        reckoned = (f"weights {memory['weights']}, AdamW moments "
                    f"{memory['moments']}, {dp} ranks' gradient buffers "
                    f"{memory['gradients']}, their mean {memory['mean']}, "
                    f"gradients in flight {memory['in_flight']}: "
                    f"{memory['total']} bytes before activations")
        if log is not None:
            log(f"[train] {arch.name}'s {arch.n_experts} experts do not split "
                f"over the {dp} data-parallel ranks: EP cannot arm, so the "
                f"data-parallel step runs the MoE blocks on moe_dense; memory "
                f"reckoned: {reckoned}, against "
                + (f"the card's {card_bytes} bytes" if card_bytes is not None
                   else f"no limit on {device}"))
            log("[train] memory " + json.dumps(dict(memory,
                                                    card_bytes=card_bytes)))
        if card_bytes is not None and memory["total"] > card_bytes:
            shape = "x".join(str(s) for s in mesh.shape)
            raise ValueError(
                f"train {arch.name} on --mesh {shape}: the data-parallel "
                f"MoE step's memory is reckoned at {reckoned}, over the "
                f"card's {card_bytes} bytes")
    # the reference's SP/EP contexts and the plan's all-to-all ring
    configure_sp(arch, mesh, plan=plan)
    sharded = None
    if ep:
        if reducer is None or reducer.n != dp:
            raise ValueError(f"the data axis's all-reduce spans "
                             f"{getattr(reducer, 'n', None)} ranks, the "
                             f"mesh's data-parallel ranks {dp}")
        kind = "ep"
        sharded = step = make_ep_train_step(model, opt, mesh, reducer,
                                            use_kernel_add)
    elif memory is not None:
        kind = "dense_moe"
        sharded = step = DenseMoETrainStep(model, opt, mesh, reducer,
                                           use_kernel_add)
    elif m > 1:
        if reducer is not None and reducer.n != dp:
            raise ValueError(f"the data axis's all-reduce spans {reducer.n} "
                             f"ranks, the mesh's data-parallel ranks {dp}")
        kind = "tensor_parallel"
        sharded = step = make_sharded_train_step(model, opt, mesh, reducer,
                                                 use_kernel_add)
    elif reducer is None:
        kind, step = "one_rank", make_train_step(model, opt)
    else:
        if reducer.n != n:
            raise ValueError(f"the plan's all-reduce spans {reducer.n} "
                             f"ranks, the mesh {n}")
        kind = "data_parallel"
        step = make_overlap_train_step(model, opt, reducer)
    return TrainBuild(kind, step, model, mesh, reducer, sharded, lay, memory)


def main() -> None:
    """Deprecated entry point: delegates to ``python -m repro_torch train``."""
    import sys

    warnings.warn(
        "python -m repro_torch.launch.train is deprecated; use "
        "`python -m repro_torch train`", DeprecationWarning, stacklevel=2)
    from repro_torch.cli import main as cli_main

    raise SystemExit(cli_main(["train", *sys.argv[1:]]))


if __name__ == "__main__":
    main()
