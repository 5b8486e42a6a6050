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
``python -m repro_torch.launch.train`` and :func:`default_job_mix` remain
as the reference's deprecated shims over the CLI's ``train`` and
:func:`repro_torch.session.train_mix`.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np

__all__ = ["apply_planned", "build_mesh", "default_job_mix", "main",
           "parse_mesh", "planning_session"]


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
