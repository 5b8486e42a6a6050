"""Fault-tolerant trainer with cloud-aware rank reordering built in.

A port of ``repro.train.trainer``.  The trainer composes what the
paper's end-to-end experiments need (§V-D) with the runnability
substrate:

* **rank-reordered mesh** — the cluster view probes its fabric, solves
  the N-D mesh plan (:mod:`repro_torch.core.reorder`) or asks a
  :class:`repro_torch.session.Session` for it, and the trainer runs in
  that order;
* **checkpoint/restart** — async atomic checkpoints every N steps
  (:mod:`repro_torch.checkpoint`);
* **node-failure handling (elastic)** — on a :class:`NodeFailure`, the
  cluster view drops the dead nodes, re-probes the surviving fabric,
  *re-solves the rank order* (paper §VI dynamic adaptation), rebuilds
  the (smaller) mesh plan, the caller's ``rebuild`` makes a step for it,
  and training resumes from the last checkpoint;
* **straggler mitigation** — per-step times feed a
  :class:`~repro_torch.core.dynamic.StragglerDetector`; when a straggler
  degrades the current order beyond threshold the
  :class:`~repro_torch.core.dynamic.AdaptiveReranker` performs the
  paper's bottleneck-edge replacement and the trainer adopts the order.

The step is any ``(state, batch) -> (state, metrics)`` callable, for
example :func:`repro_torch.train.make_overlap_train_step` over the
virtual mesh; the trainer synchronises the loss's device after each step
(where the reference blocks on the JAX array), so the step time it
records is the device's.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.core import (
    AdaptiveReranker,
    StragglerDetector,
    make_cost_model,
    optimize_mesh_assignment,
)
from repro_torch.core.reorder import MeshPlan
from repro_torch.fabric import Fabric, probe_fabric
from repro_torch.fabric import probe as probe_mod
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["NodeFailure", "ClusterView", "TrainerConfig", "Trainer"]


def _synchronize(x: Any) -> None:
    """Wait for the device that computes ``x`` (a no-op on the CPU)."""
    if torch.is_tensor(x) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class NodeFailure(RuntimeError):
    def __init__(self, nodes: List[int]):
        super().__init__(f"nodes failed: {nodes}")
        self.nodes = nodes


@dataclasses.dataclass
class ClusterView:
    """The trainer's model of the fleet: fabric + current rank order.

    ``session`` (a :class:`repro_torch.session.Session`) makes the view a
    Session consumer: :meth:`solve_plan` attaches the survivor fabric to
    the session and adopts the compiled plan's mesh assignment (cached
    under the fabric fingerprint, so elastic restarts on an unchanged
    fabric skip the solve), and the trainer's drift observations flow
    through :meth:`Session.observe` instead of a hand-wired reranker.
    """

    fabric: Fabric
    mesh_shape: tuple
    axis_names: tuple
    plan: Optional[MeshPlan] = None
    alive: Optional[List[int]] = None
    payload_bytes: float = 4e6
    session: Optional[Any] = None          # repro_torch.session.Session

    def __post_init__(self):
        if self.alive is None:
            self.alive = list(range(self.fabric.n))

    #: nodes actually occupying mesh slots (== alive unless the mesh is
    #: smaller than the survivor set after an elastic shrink)
    active: Optional[List[int]] = None

    def cost_matrix(self, nodes: Optional[List[int]] = None) -> np.ndarray:
        probed = probe_fabric(self.fabric.subset(nodes or self.alive))
        return probe_mod.cost_matrix(probed, self.payload_bytes)

    def solve_plan(self) -> MeshPlan:
        """Select + order nodes for the mesh (both are cloud-aware).

        When more nodes survive than the (power-of-two) mesh needs, keep
        the most *central* ones — lowest total cost to the rest — before
        solving the rank order.  Node selection is the zeroth-order form
        of the paper's locality exploitation.
        """
        need = int(np.prod(self.mesh_shape))
        c_all = None
        sel = None
        if len(self.alive) > need:
            c_all = self.cost_matrix()
            order = np.argsort(c_all.sum(axis=1))
            sel = sorted(int(i) for i in order[:need])
            self.active = [self.alive[i] for i in sel]
        else:
            self.active = list(self.alive)
        if self.session is not None:
            # Session consumer path: attach the survivor fabric, let the
            # planning service compile/cache the full plan, adopt its
            # N-D mesh assignment (same id space: subset-local indices).
            # The session probes the attached fabric itself, so the full
            # c_all probe above only runs when node selection needs it.
            if self.session.config.payload_bytes != self.payload_bytes:
                # one payload knob: drift observations are fed at the
                # cluster payload and must match the session reference
                self.session.config = self.session.config.replace(
                    payload_bytes=self.payload_bytes)
            self.session.attach(fabric=self.fabric.subset(self.active))
            compiled = self.session.plan(
                mesh_shape=self.mesh_shape, axis_names=self.axis_names)
            self.plan = compiled.mesh_plan
        else:
            if c_all is None:
                c = self.cost_matrix()
            else:
                c = c_all[np.ix_(sel, sel)]
            self.plan = optimize_mesh_assignment(
                c, self.mesh_shape, self.axis_names)
        return self.plan

    def fail(self, nodes: List[int]) -> None:
        self.alive = [n for n in self.alive if n not in nodes]

    def shrink_mesh(self) -> tuple:
        """Largest mesh of the same arity fitting the surviving nodes.

        Shrinks the outermost data-parallel axis first (stepwise halving)
        — the standard elastic-DP policy.
        """
        shape = list(self.mesh_shape)
        while int(np.prod(shape)) > len(self.alive):
            # halve the largest shrinkable axis (prefer axis 0 = pod/data)
            for i in range(len(shape)):
                if shape[i] > 1 and shape[i] % 2 == 0:
                    shape[i] //= 2
                    break
            else:
                raise RuntimeError("cannot shrink mesh further")
        self.mesh_shape = tuple(shape)
        return self.mesh_shape


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    rerank_threshold: float = 1.2
    max_restarts: int = 3
    #: grad-bucket payload for obs accounting (0 = one unbucketed
    #: all-reduce per step); use the planned PlanEntry.bucket_bytes
    bucket_bytes: float = 0.0


class Trainer:
    def __init__(
        self,
        step_fn: Callable,          # (state, batch) -> (state, metrics)
        state: Any,
        batches: Iterator[Dict[str, Any]],
        cfg: TrainerConfig,
        cluster: Optional[ClusterView] = None,
        failure_injector: Optional[Callable[[int], Optional[List[int]]]] = None,
        rebuild: Optional[Callable[["Trainer"], None]] = None,
    ):
        self.step_fn = step_fn
        self.state = state
        self.batches = batches
        self.cfg = cfg
        self.cluster = cluster
        self.failure_injector = failure_injector
        self.rebuild = rebuild
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir)
        self.history: List[Dict[str, float]] = []
        self.restarts = 0
        self._cached_param_bytes: Optional[float] = None
        #: per-bucket all-reduce payloads, computed once per (re)mesh
        self._cached_bucket_bytes: Optional[List[float]] = None
        self.rerank_events: List[int] = []
        if cluster is not None:
            if cluster.session is not None:
                # one sensitivity knob: the trainer's threshold governs
                # the session's drift monitor too
                cluster.session.set_drift_threshold(cfg.rerank_threshold)
            if cluster.plan is None:
                cluster.solve_plan()
            self._init_adaptation()
        else:
            self.straggler = None
            self.reranker = None

    def _init_adaptation(self) -> None:
        """(Re)build straggler detector + reranker over the ACTIVE nodes."""
        active = self.cluster.active or self.cluster.alive
        self.straggler = StragglerDetector(len(active))
        self.reranker = AdaptiveReranker(
            model_factory=lambda cm: make_cost_model("ring", cm, 0.0),
            perm=np.asarray(self.cluster.plan.flat),
            threshold=self.cfg.rerank_threshold,
        )

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        step = int(self.state.step)
        while step < self.cfg.total_steps:
            try:
                step = self._run_until_failure(step)
            except NodeFailure as failure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                self._elastic_restart(failure)
                step = int(self.state.step)
        self.ckpt.wait()
        return {
            "final_step": step,
            "restarts": self.restarts,
            "rerank_events": self.rerank_events,
            "history": self.history,
            "checkpoint": self.ckpt.last,
        }

    # ------------------------------------------------------------------
    def _run_until_failure(self, step: int) -> int:
        while step < self.cfg.total_steps:
            if self.failure_injector is not None:
                failed = self.failure_injector(step)
                if failed:
                    raise NodeFailure(failed)
            batch = next(self.batches)
            timer = obs.tracer().timer("train.step", step=step + 1)
            with timer:
                self.state, metrics = self.step_fn(self.state, batch)
                _synchronize(metrics["loss"])
            dt = timer.elapsed
            step += 1
            obs.metrics().counter("train.steps").inc()
            # the data-parallel gradient all-reduce is the step's one
            # fleet-wide collective; record it at bucket granularity so
            # the captured workload prices what the overlap path issues
            rec = obs.recorder()
            for payload in self._bucket_bytes():
                rec.record("all-reduce", payload)
            self._observe_step(step, dt, metrics)
            if step % self.cfg.ckpt_every == 0 or step == self.cfg.total_steps:
                self.ckpt.save(step, self.state)
        return step

    def _param_bytes(self) -> float:
        """Total parameter bytes (the per-step all-reduce payload)."""
        if self._cached_param_bytes is None:
            params = getattr(self.state, "params", None)
            self._cached_param_bytes = float(sum(
                x.numel() * x.element_size() for x in tree_leaves(params)
                if torch.is_tensor(x)))
        return self._cached_param_bytes

    def _bucket_bytes(self) -> List[float]:
        """Per-bucket all-reduce payloads (one entry when unbucketed).

        Cached alongside ``_param_bytes`` and likewise invalidated on
        elastic restart — bucket boundaries only move when the params
        (or ``cfg.bucket_bytes``) do.
        """
        if self._cached_bucket_bytes is None:
            if self.cfg.bucket_bytes > 0:
                from .overlap_grads import partition_tree

                params = getattr(self.state, "params", None)
                buckets = partition_tree(params, self.cfg.bucket_bytes)
                self._cached_bucket_bytes = [float(b.n_bytes)
                                             for b in buckets]
                obs.metrics().gauge("train.overlap.buckets").set(
                    len(buckets))
            else:
                self._cached_bucket_bytes = [self._param_bytes()]
        return self._cached_bucket_bytes

    def _observe_step(self, step: int, dt: float, metrics: Dict) -> None:
        if step % self.cfg.log_every == 0 or step <= 2:
            self.history.append(
                {"step": step, "loss": float(metrics["loss"]), "sec": dt})
        if self.straggler is not None:
            # On a real fleet this is per-host step time collected via
            # heartbeats; simulated here by observing node 0.
            self.straggler.observe(0, dt)
            if self.cluster is not None and step % 10 == 0:
                active = self.cluster.active or self.cluster.alive
                c = self.straggler.inflate(self.cluster.cost_matrix(active))
                if self.cluster.session is not None \
                        and self.cluster.session.planned is not None:
                    # a preset cluster.plan means the session never
                    # compiled: fall to the reranker branch below
                    report = self.cluster.session.observe(c)
                    changed = report.stale
                    replanned = self.cluster.session.planned
                    if changed and replanned is not None \
                            and replanned.mesh_plan is not None:
                        self.cluster.plan = replanned.mesh_plan
                else:
                    _, changed = self.reranker.update(c)
                if changed:
                    self.rerank_events.append(step)

    # ------------------------------------------------------------------
    def _elastic_restart(self, failure: NodeFailure) -> None:
        """Drop dead nodes, re-plan the mesh (paper §VI), restore, go on."""
        if self.cluster is None:
            raise RuntimeError("an elastic restart needs a ClusterView") from failure
        self.cluster.fail(failure.nodes)
        self.cluster.shrink_mesh()
        self.cluster.solve_plan()           # re-probe + re-solve rank order
        if self.rebuild is not None:
            self.rebuild(self)              # caller re-jits step_fn / data
        # restore from the last durable checkpoint
        self.ckpt.wait()
        step = latest_step(self.cfg.ckpt_dir)
        if step is not None:
            restored, _, _ = restore(self.cfg.ckpt_dir, self.state, step)
            # back onto each leaf's device (the rebuilt step's state may
            # live elsewhere than the checkpoint's CPU tensors)
            self.state = tree_map(lambda r, t: r.to(t.device), restored,
                                  self.state)
        # the rebuilt step may carry differently-shaped params (elastic
        # remesh): recompute payloads on next use instead of reporting
        # the dead mesh's numbers
        self._cached_param_bytes = None
        self._cached_bucket_bytes = None
        self._init_adaptation()
