"""The Session facade: probe → plan → apply → monitor in one object.

A port of ``repro.session.session``.  The paper's headline property is
that Cloud Collectives is *non-intrusive*: the manual chain
(``make_datacenter → probe_fabric → cost_matrix → PlanCompiler →
PlanCache → PlanningService.request → make_planned_mesh →
reducer_from_plan``) sits behind one declarative
:class:`~repro_torch.session.config.SessionConfig`::

    from repro_torch import Session, SessionConfig

    cfg = SessionConfig.from_dict({
        "fabric": {"kind": "datacenter", "nodes": 8, "scramble_seed": 1},
        "mesh": {"shape": "8"},
        "payload_bytes": 988_065_536,
    })
    with Session(cfg) as s:
        applied = s.apply(device="cuda")   # lazily probes + plans + applies
        mesh = applied.mesh                # the planned virtual mesh
        reducer = s.overlap_step(mode="bucketed")

Lifecycle is an explicit state machine — ``created → attached → planned
→ applied → closed`` — with registered hooks (``on("plan", fn)`` etc.),
a :meth:`Session.observe` / :meth:`Session.monitor` drift path wiring
:class:`repro_torch.plan.DriftMonitor` re-plans, and elastic membership
(:meth:`Session.on_node_leave` / :meth:`Session.on_node_join`).

Where the port differs from the reference:

* :meth:`Session.apply` builds the planned *virtual* mesh
  (:func:`repro_torch.launch.mesh.make_planned_mesh`: the rank order on
  one device) and raises when it cannot; the reference warns and hands
  back ``mesh=None``, and its launcher then trains unreordered;
* ``fabric.kind="live"`` raises until the device probe is ported
  (ROADMAP.md §1 item 13);
* :meth:`Session.executor` takes the reference's backends; ``"jax"``,
  the reference's name for its lowering backend, returns the port's
  :class:`~repro_torch.collective.ScheduleLowering`.
  :meth:`Session.lower` hands runtimes the plan's certified
  :class:`~repro_torch.collective.Lowered`: the serve engine's planned
  all-gather, and the process-group runner
  (:mod:`repro_torch.kernels.group_runner`);
* :meth:`Session.wrap` patches the port's
  :func:`repro_torch.launch.mesh.make_production_mesh` and
  :func:`repro_torch.parallel.moe_a2a.arm_ep`; the port's ``arm_ep`` also
  takes ``session=``, so the patch supplies the plan only where the
  caller passed neither.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.fabric import (
    Fabric,
    ProbeResult,
    SparseProbeResult,
    cost_matrix,
    make_datacenter,
    make_tpu_fleet,
    probe_fabric,
    refresh_sparse,
    scramble,
    sparse_probe_fabric,
)
from repro_torch.faults import (
    HealthTracker,
    call_with_retries,
    identity_fallback,
    recover_plan,
)
from repro_torch.plan import (
    DriftMonitor,
    DriftReport,
    JobMix,
    Plan,
    PlanCache,
    PlanCompiler,
    PlanningService,
)

from .config import ObsConfig, SessionConfig
from .mixes import default_mix

__all__ = ["Session", "SessionError", "AppliedPlan", "EVENTS"]

#: where the live-fleet probe waits (``fabric.kind="live"``)
LIVE_PROBE_ITEM = "ROADMAP.md §1 item 13 (the device probe)"

#: lifecycle hook names accepted by :meth:`Session.on`; ``degraded`` /
#: ``recovered`` report health-state edges, ``node_leave`` /
#: ``node_join`` report elastic membership changes
EVENTS = ("attach", "plan", "apply", "drift", "replan",
          "degraded", "recovered", "node_leave", "node_join", "close")

_STATES = ("created", "attached", "planned", "applied", "closed")


class SessionError(RuntimeError):
    """Lifecycle misuse (e.g. planning on a closed session)."""


@dataclasses.dataclass
class AppliedPlan:
    """What :meth:`Session.apply` hands the application."""

    plan: Plan
    #: flat rank order of the mesh assignment (None without a mesh plan)
    order: Optional[np.ndarray]
    #: the planned virtual mesh (:class:`repro_torch.launch.mesh.PlannedMesh`;
    #: None without a mesh plan)
    mesh: Optional[Any]
    #: per-op entry summaries: {op: {algo, chunks, expected_time, ...}}
    hints: Dict[str, Dict[str, Any]]

    def summary(self) -> str:
        lines = [f"plan {self.plan.fingerprint.digest}: "
                 f"{len(self.plan.entries)} entries, "
                 f"compiled in {self.plan.compile_seconds:.2f}s"]
        mp = self.plan.mesh_plan
        if mp is not None:
            lines.append(
                f"mesh {mp.assignment.shape} cost {mp.baseline_cost:.5f} -> "
                f"{mp.cost:.5f} "
                f"({mp.baseline_cost / max(mp.cost, 1e-30):.2f}x vs identity)")
        for op, h in sorted(self.hints.items()):
            lines.append(
                f"  {op:<15} {h['algo']:<20} chunks={h['chunks']} "
                f"{h['speedup_vs_identity']:.2f}x vs identity order")
        return "\n".join(lines)


class _WrapGuard:
    """Returned by :meth:`Session.wrap`; scopes the patches to a ``with``
    block without closing the session (bare calls patch until
    ``unwrap``/``close``)."""

    def __init__(self, session: "Session"):
        self.session = session

    def __enter__(self) -> "Session":
        return self.session

    def __exit__(self, *exc) -> None:
        self.session.unwrap()


class Session:
    """Owns the probe → plan → apply → monitor lifecycle (see module doc)."""

    def __init__(self, config: Optional[SessionConfig] = None, **overrides: Any):
        if isinstance(config, dict):
            config = SessionConfig.from_dict(config)
        self.config = (config or SessionConfig())
        if overrides:
            self.config = self.config.replace(**overrides)
        # apply a non-default obs section to the process singletons; the
        # default section is left alone so a tracer a test (or another
        # session) enabled explicitly is not silently disabled here
        if self.config.obs != ObsConfig():
            obs.configure(self.config.obs)
        self.state = "created"
        self.events: List[Tuple[str, Dict[str, Any]]] = []
        self._hooks: Dict[str, List[Callable]] = {e: [] for e in EVENTS}
        self._fabric: Optional[Fabric] = None
        #: oracle the compiler scores candidates against; equals _fabric
        #: after attach, None after a drift re-plan (the stale fabric no
        #: longer reflects observed conditions -> cost-model oracle)
        self._oracle_fabric: Optional[Fabric] = None
        self._probe: Optional[ProbeResult] = None
        self._plan: Optional[Plan] = None
        self._mix: Optional[JobMix] = None
        self._mesh_shape: Optional[Tuple[int, ...]] = None
        self._axis_names: Optional[Tuple[str, ...]] = None
        self._cache: Optional[PlanCache] = None
        self._service: Optional[PlanningService] = None
        self._drift: Optional[DriftMonitor] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        #: (module, attribute, original) of every wrap() patch
        self._patches: List[Tuple[Any, str, Any]] = []
        #: the sparse poll's freshly refreshed probe, consumed by the
        #: next _replan so a drift recompile keeps the hierarchy (and
        #: does not re-spend the probe budget from scratch)
        self._sparse_fresh: Optional[SparseProbeResult] = None
        self._lock = threading.RLock()
        #: healthy → degraded → halted (thresholds from the retry policy)
        self._health = HealthTracker(
            failure_threshold=self.config.retry.failure_threshold,
            halt_threshold=self.config.retry.halt_threshold)
        #: the fabric as first attached — the topology elastic membership
        #: subsets (None when attached from a bare probe / live fleet)
        self._base_fabric: Optional[Fabric] = None
        #: currently-live node ids in the attached numbering; index k of
        #: the current probe/plan is node _alive[k] of the attach-time
        #: fabric (None before attach)
        self._alive: Optional[List[int]] = None

    # -- context management ------------------------------------------------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"Session(name={self.config.name!r}, state={self.state!r}, "
                f"fabric={self.config.fabric.kind!r})")

    # -- hooks -------------------------------------------------------------
    def on(self, event: str, fn: Callable[..., None]) -> "Session":
        """Register ``fn(session, **info)`` for a lifecycle event."""
        if event not in EVENTS:
            raise ValueError(f"unknown session event {event!r}; "
                             f"expected one of {EVENTS}")
        self._hooks[event].append(fn)
        return self

    def _fire(self, event: str, **info: Any) -> None:
        self.events.append((event, info))
        for fn in self._hooks[event]:
            fn(self, **info)

    def _require_open(self, doing: str) -> None:
        if self.state == "closed":
            raise SessionError(f"cannot {doing}: session is closed")

    # -- lifecycle: attach -------------------------------------------------
    def attach(self, fabric: Optional[Fabric] = None,
               probe: Optional[Any] = None) -> "Session":
        """Bind the session to a fabric and/or probe result.

        With no arguments the configured fabric is built and probed
        (synthetic kinds; ``fabric.kind="live"`` raises until the device
        probe is ported).
        ``probe`` may be a :class:`ProbeResult` or a raw [n, n] cost
        matrix.  Re-attaching resets any existing plan.
        """
        self._require_open("attach")
        cfg = self.config
        with obs.tracer().span("session.attach", kind=cfg.fabric.kind):
            if probe is not None and not isinstance(probe, ProbeResult):
                lat = np.asarray(probe, dtype=np.float64)
                probe = ProbeResult(lat=lat)
            if fabric is None and probe is None:
                fabric, probe = self._build_configured_fabric()
            elif probe is None:
                probe = self._probe_fabric(fabric)
        obs.metrics().counter("session.attaches").inc()
        with self._lock:
            self._fabric = fabric
            self._oracle_fabric = fabric
            self._probe = probe
            self._plan = None
            self._drift = None
            self._sparse_fresh = None
            self._base_fabric = fabric
            self._alive = list(range(probe.n))
            self._health.reset()
            if self._service is not None:
                self._service.close()
                self._service = None
            self.state = "attached"
        self._fire("attach", fabric=fabric, probe=probe)
        return self

    def _build_configured_fabric(self) -> Tuple[Optional[Fabric], ProbeResult]:
        cfg = self.config
        f = cfg.fabric
        if f.kind == "live":
            raise SessionError(
                f"fabric.kind='live' probes the devices themselves, which "
                f"waits for {LIVE_PROBE_ITEM}; attach a synthetic fabric "
                f"('datacenter' or 'tpu-fleet') or pass probe= a measured "
                f"cost matrix")
        if f.kind == "tpu-fleet":
            fabric = make_tpu_fleet(
                n_pods=f.n_pods, pod_shape=tuple(f.pod_shape),
                fragmentation=f.fragmentation, seed=f.seed)
        else:
            fabric = make_datacenter(f.nodes, seed=f.seed)
        if f.scramble_seed is not None:
            fabric, _ = scramble(fabric, seed=f.scramble_seed)
        return fabric, self._probe_fabric(fabric)

    def _probe_fabric(self, fabric: Fabric) -> ProbeResult:
        """Probe per the configured mode: dense (paper §IV-B) or sparse
        (budgeted O(n·log n) probing + hierarchy recovery).

        Runs under the session retry policy: a transient probe failure
        (an injected :class:`repro_torch.faults.ProbeTimeout`, a wedged
        sweep) is retried with capped backoff before it surfaces.
        """
        p = self.config.probe

        def sweep() -> ProbeResult:
            if p.mode == "sparse":
                return sparse_probe_fabric(
                    fabric, budget=p.budget, n_probes=p.n_probes,
                    percentile=p.percentile, noise_scale=p.noise_scale,
                    seed=p.seed, measure_bw=p.measure_bw)
            return probe_fabric(
                fabric, n_probes=p.n_probes, percentile=p.percentile,
                noise_scale=p.noise_scale, seed=p.seed,
                measure_bw=p.measure_bw)

        return call_with_retries(sweep, self.config.retry,
                                 sleep=self._monitor_stop.wait)

    # -- lifecycle: plan ---------------------------------------------------
    @property
    def cache(self) -> PlanCache:
        """The session-lifetime plan cache (survives re-attaches, so an
        elastic restart on an unchanged fabric hits the cached plan)."""
        with self._lock:
            if self._cache is None:
                cfg = self.config
                self._cache = PlanCache(capacity=cfg.cache.capacity,
                                        store_dir=cfg.cache.dir,
                                        tol=cfg.cache.tol)
            return self._cache

    @property
    def service(self) -> PlanningService:
        """The lazily built planning service (fabric-bound compiler over
        the session-lifetime cache)."""
        self._require_open("use the planning service")
        cache = self.cache
        with self._lock:
            if self._service is None:
                cfg = self.config
                self._service = PlanningService(
                    PlanCompiler(fabric=self._oracle_fabric,
                                 budget=cfg.solver.budget,
                                 seed=cfg.solver.seed),
                    cache, retry=cfg.retry)
            return self._service

    def plan(self, mix: Optional[JobMix] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             axis_names: Optional[Sequence[str]] = None) -> Plan:
        """Compile (or fetch from cache) the plan for this session.

        Lazy: attaches the configured fabric first if needed.  ``mix``
        defaults to the configured workload's canonical histogram;
        ``mesh_shape`` / ``axis_names`` default to the configured mesh.
        """
        self._require_open("plan")
        if self.state == "created":
            self.attach()
        cfg = self.config
        mix = mix or default_mix(cfg.workload, cfg.payload_bytes, moe=cfg.moe)
        if mesh_shape is None and cfg.mesh.shape:
            mesh_shape = cfg.mesh.shape
            axis_names = axis_names or cfg.mesh.axis_names
        mesh_shape = tuple(mesh_shape) if mesh_shape else None
        axis_names = tuple(axis_names) if axis_names else None
        if mesh_shape is not None and \
                int(np.prod(mesh_shape)) != self._probe.n:
            raise ValueError(
                f"mesh shape {mesh_shape} needs "
                f"{int(np.prod(mesh_shape))} nodes but the attached "
                f"fabric has {self._probe.n}; attach a matching fabric "
                f"or fix mesh.shape in the session config")
        with obs.tracer().span("session.plan", mix=mix.name) as sp:
            plan = self.service.request(
                self._probe, mix, mesh_shape=mesh_shape,
                axis_names=axis_names)
            sp.set(entries=len(plan.entries),
                   digest=plan.fingerprint.digest)
        with self._lock:
            self._plan = plan
            self._mix = mix
            self._mesh_shape = mesh_shape
            self._axis_names = axis_names
            self._drift = DriftMonitor(
                plan, self.reference_matrix(),
                cache=self.service.cache,
                threshold=cfg.drift.threshold)
            if self.state in ("created", "attached"):
                self.state = "planned"
        self._fire("plan", plan=plan, mix=mix)
        return plan

    def reference_matrix(self) -> np.ndarray:
        """The cost matrix the current plan is calibrated against
        (probed latency + payload/bandwidth at the session payload) —
        the baseline that :meth:`observe` inputs are compared to."""
        if self._probe is None:
            raise SessionError(
                "reference_matrix() needs an attached probe; call "
                "attach() first")
        return cost_matrix(self._probe, self.config.payload_bytes)

    @property
    def planned(self) -> Optional[Plan]:
        """The current plan, or None before :meth:`plan` ran."""
        return self._plan

    @property
    def probe(self) -> Optional[ProbeResult]:
        """The attached probe result, or None before :meth:`attach`."""
        return self._probe

    @property
    def mix(self) -> Optional[JobMix]:
        """The job mix of the current plan, or None before :meth:`plan`."""
        return self._mix

    @property
    def hierarchy(self):
        """The recovered locality tree of the attached probe
        (:class:`repro_torch.fabric.HierarchyModel`), or None when the probe
        carries none (dense mode / raw matrices)."""
        return getattr(self._probe, "hierarchy", None)

    @property
    def health(self) -> str:
        """Current health state: ``healthy`` / ``degraded`` / ``halted``."""
        return self._health.state

    @property
    def health_tracker(self) -> HealthTracker:
        """The underlying tracker (transition log, counters, reset)."""
        return self._health

    @property
    def alive(self) -> Optional[List[int]]:
        """Live node ids in the attach-time numbering (None pre-attach)."""
        return None if self._alive is None else list(self._alive)

    # -- lifecycle: apply --------------------------------------------------
    def apply(self, device: Any = "cuda") -> AppliedPlan:
        """Materialize the plan for the application (lazily planning).

        Returns an :class:`AppliedPlan`: the plan, the flat rank order of
        its N-D mesh assignment, the planned virtual mesh on ``device``
        (CUDA unless the caller passes ``"cpu"``), and per-op hints.
        A mesh plan that cannot be applied raises: the port never trains
        on an unreordered mesh in its place.
        """
        from repro_torch.launch.mesh import make_planned_mesh

        self._require_open("apply")
        plan = self._plan if self._plan is not None else self.plan()
        order = None
        mesh = None
        with obs.tracer().span("session.apply",
                               digest=plan.fingerprint.digest):
            if plan.mesh_plan is not None:
                order = plan.mesh_plan.flat
                mesh = make_planned_mesh(plan, device)
        obs.metrics().counter("session.applies").inc()
        applied = AppliedPlan(plan=plan, order=order, mesh=mesh,
                              hints=self.hints())
        with self._lock:
            if self.state == "planned":
                self.state = "applied"
        self._fire("apply", applied=applied)
        return applied

    def hints(self, payload_bytes: Optional[float] = None) -> Dict[str, Dict]:
        """Per-op entry summaries of the current plan (empty pre-plan)."""
        if self._plan is None:
            return {}
        payload = payload_bytes or self.config.payload_bytes
        out: Dict[str, Dict] = {}
        for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"):
            e = self._plan.lookup(op, payload)
            if e is not None:
                out[op] = {
                    "algo": e.algo, "chunks": e.chunks,
                    "expected_time": e.expected_time,
                    "speedup_vs_identity":
                        e.best_identity_time / max(e.expected_time, 1e-30),
                }
        return out

    # -- collective IR: executors + lowering -------------------------------
    def executor(self, backend: str = "auto"):
        """A pricing or lowering executor bound to this session.

        * ``"sim"``: :class:`~repro_torch.collective.SimExecutor` over the
          attached fabric (the contention-aware oracle the plan was
          scored on);
        * ``"analytic"``: :class:`~repro_torch.collective.AnalyticExecutor`
          over the probed lat/bw matrices (the only pricing available
          after a drift re-plan);
        * ``"jax"`` (the reference's name):
          :class:`~repro_torch.collective.ScheduleLowering`, which lowers
          and does not price;
        * ``"auto"``: ``sim`` when a fabric oracle is attached, else
          ``analytic``, whatever the compiler would score with now.
        """
        from repro_torch.collective import (
            AnalyticExecutor, ScheduleLowering, SimExecutor)

        self._require_open("build an executor")
        if backend == "jax":
            return ScheduleLowering()
        if backend not in ("auto", "sim", "analytic"):
            raise ValueError(f"unknown executor backend {backend!r}; "
                             f"expected 'auto', 'sim', 'analytic' or 'jax'")
        # attach before resolving "auto": a session not yet attached has
        # no oracle fabric, and would pick another backend than the
        # compiler's own oracle
        if self._probe is None:
            self.attach()
        if backend == "auto":
            backend = "sim" if self._oracle_fabric is not None else "analytic"
        if backend == "sim":
            if self._oracle_fabric is None:
                raise SessionError(
                    "executor('sim') needs an attached fabric oracle; "
                    "attach a synthetic fabric or use 'analytic'")
            return SimExecutor(self._oracle_fabric)
        probe = self._probe
        if probe.bw is not None:
            return AnalyticExecutor(lat=probe.lat, bw=probe.bw)
        return AnalyticExecutor(cost_matrix=probe.lat)

    def lower(self, op: str, size_bytes: Optional[float] = None,
              group: Optional[Sequence[int]] = None):
        """The plan's certified :class:`~repro_torch.collective.Lowered`
        for ``op`` at ``size_bytes`` (default: the session payload),
        planning first if need be.

        The entry's program is re-verified through the full gate
        (:data:`~repro_torch.analysis.GATE_PASSES`, the ``equiv``
        translation validator among them), lowered with
        :class:`~repro_torch.collective.ScheduleLowering`, and the exact
        schedule returned is certified against the program: nothing
        uncertified reaches a runtime.
        """
        from repro_torch.analysis import (
            GATE_PASSES, require_certified, require_valid)
        from repro_torch.collective import ScheduleLowering

        self._require_open("lower")
        if self._plan is None:
            self.plan()
        payload = self.config.payload_bytes if size_bytes is None \
            else float(size_bytes)
        entry = self._plan.lookup(op, payload, group)
        if entry is None:
            raise SessionError(
                f"plan has no entry for op {op!r} at {payload:.0f} bytes; "
                f"planned ops: {sorted({k[0] for k in self._plan.entries})}")
        prog = entry.program()
        require_valid(prog, passes=GATE_PASSES)
        lowered = ScheduleLowering().lower(prog)
        require_certified(prog, lowered.schedule)
        return lowered

    def overlap_step(self, *, total_bytes: Optional[float] = None,
                     mode: Optional[str] = None,
                     bucket_bytes: Optional[float] = None,
                     transport: str = "peer_ring"):
        """A certified overlap reducer for the train step's grad all-reduce.

        Returns an :class:`~repro_torch.train.OverlapGradReducer` from the
        plan's certified all-reduce (:func:`repro_torch.train.reducer_from_plan`),
        ready for :func:`repro_torch.train.make_overlap_train_step`.
        Resolution order for every knob is explicit argument >
        ``config.overlap`` > plan: the bucket payload defaults to the
        planned ``PlanEntry.bucket_bytes`` of the full grad payload's
        octave.  ``mode="off"`` in both the argument and the config is
        an error: this builds the overlapped reducer.  ``transport`` is
        ``"peer_ring"`` (one ring-kernel launch a bucket) or ``"runner"``.
        """
        self._require_open("build an overlap reducer")
        from repro_torch.train.overlap_grads import (
            OVERLAP_MODES, reducer_from_plan)

        cfg = self.config.overlap
        mode = cfg.mode if mode is None else mode
        if mode == "off":
            raise SessionError(
                "overlap_step() with mode 'off'; set "
                "SessionConfig.overlap.mode or pass mode= one of "
                f"{OVERLAP_MODES}")
        if mode not in OVERLAP_MODES:
            raise SessionError(
                f"unknown overlap mode {mode!r}; expected one of "
                f"{OVERLAP_MODES}")
        total = self.config.payload_bytes if total_bytes is None \
            else float(total_bytes)
        bb = cfg.bucket_bytes if bucket_bytes is None else float(bucket_bytes)
        if self._plan is None:
            self.plan()
        if self._plan.lookup("all-reduce", total) is None:
            raise SessionError(
                "plan has no all-reduce entry; overlap_step() plans the "
                "gradient all-reduce — include one in the job mix")
        return reducer_from_plan(
            self._plan, total, mode=mode,
            bucket_bytes=bb if bb > 0 else None,
            use_kernel_add=cfg.use_kernel_add, transport=transport)

    # -- drift: observe / monitor -----------------------------------------
    def observe(self, cost_matrix_now: np.ndarray) -> DriftReport:
        """Feed a refreshed full-fabric cost matrix into drift tracking.

        Degraded entries are hot-patched via the per-entry
        :class:`~repro_torch.core.dynamic.AdaptiveReranker`s, the cached plan
        is invalidated, and — with ``drift.auto_replan`` — the session
        recompiles against the observed matrix and fires ``replan``.
        """
        self._require_open("observe")
        if self._drift is None:
            raise SessionError("observe() needs a plan; call plan() first")
        with obs.tracer().span("session.observe") as sp:
            report = self._drift.observe(cost_matrix_now)
            sp.set(stale=report.stale, degraded=len(report.degraded))
        if report.stale:
            self._fire("drift", report=report)
            if self.config.drift.auto_replan:
                self._replan(np.asarray(cost_matrix_now, dtype=np.float64))
        return report

    def set_drift_threshold(self, threshold: float) -> None:
        """Change drift sensitivity, applying to the live monitor too.

        Consumers with their own sensitivity knob (the Trainer's
        ``rerank_threshold``) call this so one configured value governs
        both paths.
        """
        self.config = self.config.replace(
            drift={"threshold": float(threshold)})
        if self._drift is not None:
            self._drift.set_threshold(threshold)

    def _replan(self, observed: np.ndarray) -> Plan:
        """Recompile against drifted costs.

        The observed matrix is a full cost matrix at the session payload
        — it already embeds the bandwidth term — so it becomes the
        single (paper-mode) cost matrix of the re-plan.  Re-attaching
        the probed bw here would double-count bandwidth in the compiler
        and inflate the next drift reference.  The compiler's oracle
        also switches to the analytic cost model: the attached fabric
        simulator predates the drift, so ranking candidates on it would
        ignore exactly the congestion that triggered the re-plan.

        When the observation came from the sparse poll, the poll's
        freshly refreshed :class:`SparseProbeResult` (separate lat/bw,
        recovered hierarchy, landmark state) becomes the re-plan probe
        instead: the recompile stays hierarchy-decomposed and keeps the
        tree fingerprint, and the next poll tick resumes cluster
        tracking from it rather than re-spending the probe budget.
        """
        old = self._plan
        fresh, self._sparse_fresh = self._sparse_fresh, None
        if fresh is not None and fresh.n == observed.shape[0]:
            probe: ProbeResult = fresh
        else:
            probe = ProbeResult(lat=observed, bw=None)
        with self._lock:
            self._probe = probe
            self._oracle_fabric = None
            if self._service is not None:      # rebuild on the new oracle
                self._service.close()
                self._service = None
        with obs.tracer().span("session.replan"):
            plan = self.plan(mix=self._mix, mesh_shape=self._mesh_shape,
                             axis_names=self._axis_names)
        obs.metrics().counter("session.replans").inc()
        self._fire("replan", plan=plan, previous=old)
        return plan

    def monitor(self, poll: Optional[Callable[[], Optional[np.ndarray]]] = None,
                interval_s: Optional[float] = None) -> threading.Thread:
        """Start the background drift monitor.

        ``poll()`` returns a refreshed cost matrix (or None to skip a
        tick); the default re-probes the attached synthetic fabric with
        a rotating seed.  The thread is a daemon and stops at
        :meth:`close`.

        Tick failures (a timed-out probe, a recompile racing a
        re-attach) are governed by the session retry policy instead of
        a bare warning per failure: consecutive failures back off
        exponentially (capped, jittered — a flapping probe cannot spin
        the thread hot), cross ``retry.failure_threshold`` and the
        session enters ``degraded`` (firing the ``degraded`` hook while
        continuing to serve the last good plan), cross
        ``retry.halt_threshold`` and it enters ``halted``: the plan is
        pinned to identity order — the one order that needs no fresh
        fabric knowledge — and the monitor stops burning probes.  A
        clean tick from ``degraded`` fires ``recovered``.  No exception
        ever escapes the monitor thread.
        """
        self._require_open("monitor")
        if self._plan is None:
            self.plan()
        if self._monitor_thread is not None and self._monitor_thread.is_alive():
            raise SessionError("monitor already running")
        interval = self.config.drift.interval_s if interval_s is None \
            else float(interval_s)
        if poll is None:
            if self._fabric is None:
                raise SessionError(
                    "default monitor poll needs an attached fabric; pass "
                    "poll= for live fleets")
            poll = self._default_poll()
        self._monitor_stop.clear()
        policy = self.config.retry
        rng = np.random.default_rng(policy.seed)

        def tick() -> None:
            obs.metrics().counter("session.monitor.ticks").inc()
            with obs.tracer().span("session.monitor.tick") as sp:
                c = poll()
                sp.set(observed=c is not None)
                if c is not None and self.state != "closed" \
                        and self._drift is not None:
                    self.observe(c)

        def loop() -> None:
            while not self._monitor_stop.wait(interval):
                if self._health.state == "halted":
                    return
                try:
                    tick()
                except Exception as e:
                    obs.metrics().counter("session.monitor.failures").inc()
                    entered = self._health.record_failure(repr(e))
                    if entered == "degraded":
                        self._safe_fire("degraded", state="degraded",
                                        reason=repr(e))
                    elif entered == "halted":
                        self._halt(repr(e))
                        return
                    # capped, jittered backoff between consecutive
                    # failures; close() interrupts it immediately
                    backoff = policy.delay(
                        self._health.consecutive_failures, rng)
                    if backoff > 0.0 and self._monitor_stop.wait(backoff):
                        return
                else:
                    if self._health.record_success() == "healthy":
                        self._safe_fire("recovered", state="healthy")

        t = threading.Thread(target=loop, daemon=True,
                             name=f"repro-session-monitor-{self.config.name}")
        self._monitor_thread = t
        t.start()
        return t

    def _safe_fire(self, event: str, **info: Any) -> None:
        """Fire hooks from the monitor thread; a raising hook is reported
        as a warning, never an escaping exception."""
        try:
            self._fire(event, **info)
        except Exception as e:
            # stacklevel=2 points at the monitor-loop frame that fired
            # the hook — there is no user frame above a daemon thread
            obs.tracer().event("session.hook_error", event=event,
                               error=repr(e))
            obs.metrics().counter("session.hook_errors").inc()
            warnings.warn(
                f"session {event!r} hook raised {e!r}; monitor continues",
                RuntimeWarning, stacklevel=2)

    def _halt(self, reason: str) -> None:
        """Bottom of the degradation ladder: pin identity order.

        Probing has failed ``retry.halt_threshold`` consecutive times —
        whatever the plan believes about the fabric is stale beyond
        repair, and identity order is the one order that is never worse
        than identity.  Only :meth:`HealthTracker.reset` (or a
        re-attach) returns the session to service.
        """
        with self._lock:
            if self._plan is not None:
                identity_fallback(self._plan)
        self._safe_fire("degraded", state="halted", reason=reason)

    def _default_poll(self) -> Callable[[], Optional[np.ndarray]]:
        tick = {"n": 0}
        cfg = self.config
        if cfg.probe.mode == "sparse" and \
                isinstance(self._probe, SparseProbeResult):
            # cluster-scoped monitoring: each tick re-probes every
            # cluster's sentinel against the landmarks and fully
            # re-probes ONLY the clusters that moved — a quiet fabric
            # costs O(K·L) probes per tick, not n^2
            state = {"probe": self._probe, "attached": self._probe}

            def poll_sparse() -> Optional[np.ndarray]:
                tick["n"] += 1
                fab = self._fabric
                if fab is None:          # re-attached onto a raw probe
                    return None
                if self._probe is not state["attached"]:
                    # a re-attach replaced the probe mid-monitor: restart
                    # cluster tracking from the session's current state
                    # (a fresh sparse probe when the new one isn't sparse)
                    state["attached"] = self._probe
                    state["probe"] = self._probe \
                        if isinstance(self._probe, SparseProbeResult) \
                        else None
                if state["probe"] is None or state["probe"].n != fab.n:
                    state["probe"] = self._probe_fabric(fab)
                    if not isinstance(state["probe"], SparseProbeResult):
                        return cost_matrix(state["probe"],
                                           cfg.payload_bytes)
                refreshed, moved = refresh_sparse(
                    fab, state["probe"],
                    seed=cfg.probe.seed + tick["n"],
                    percentile=cfg.probe.percentile,
                    noise_scale=cfg.probe.noise_scale,
                    measure_bw=cfg.probe.measure_bw)
                state["probe"] = refreshed
                if not moved:
                    return None          # nothing moved: skip the tick
                self._sparse_fresh = refreshed
                return cost_matrix(refreshed, cfg.payload_bytes)

            return poll_sparse

        def poll() -> np.ndarray:
            tick["n"] += 1
            probed = probe_fabric(
                self._fabric, n_probes=cfg.probe.n_probes,
                percentile=cfg.probe.percentile,
                noise_scale=cfg.probe.noise_scale,
                seed=cfg.probe.seed + tick["n"],
                measure_bw=cfg.probe.measure_bw)
            return cost_matrix(probed, cfg.payload_bytes)

        return poll

    # -- elastic membership ------------------------------------------------
    def on_node_leave(self, nodes: Sequence[int]) -> Optional[Plan]:
        """Handle departed nodes (preemption, failure) without recompiling.

        ``nodes`` are rank ids in the *current* numbering.  The fabric
        and probe are restricted to the survivors (``Fabric.subset`` /
        ``ProbeResult.subset``, which also restricts the recovered
        hierarchy), and every cached plan entry is warm-recovered onto
        the surviving ranks through the degradation ladder
        (:func:`repro_torch.faults.recover_plan`): the previous permutation is
        restricted and refined with a small budget — no cold compile —
        and entries whose algorithm became infeasible at the new group
        size (power-of-two builders) are re-selected among feasible
        candidates.  Fires ``node_leave`` with the per-entry ladder
        rungs.  Returns the recovered plan (None when the session had
        no plan, or recovery itself failed and the session degraded to
        plan-less).
        """
        self._require_open("handle node departure")
        if self._probe is None:
            raise SessionError(
                "on_node_leave needs an attached session; call attach()")
        n = self._probe.n
        leave = sorted({int(x) for x in nodes})
        if not leave:
            raise ValueError("on_node_leave needs at least one node id")
        bad = [x for x in leave if x < 0 or x >= n]
        if bad:
            raise ValueError(
                f"on_node_leave ids {bad} outside the fabric of {n} nodes")
        survivors = [i for i in range(n) if i not in set(leave)]
        if len(survivors) < 2:
            raise SessionError(
                f"cannot drop {len(leave)} of {n} nodes: fewer than 2 "
                f"survivors")
        new_fabric = self._fabric.subset(survivors) \
            if self._fabric is not None else None
        new_probe = self._probe.subset(survivors)
        old_to_new = {old: new for new, old in enumerate(survivors)}
        with self._lock:
            if self._alive is not None and len(self._alive) == n:
                self._alive = [self._alive[k] for k in survivors]
        plan, rungs = self._rebind_membership(
            new_fabric, new_probe, old_to_new, ())
        self._fire("node_leave", nodes=tuple(leave),
                   survivors=tuple(survivors), rungs=rungs, plan=plan)
        return plan

    def on_node_join(self, nodes: Optional[Sequence[int]] = None,
                     count: int = 1) -> Optional[Plan]:
        """Handle (re)joining nodes — the other half of elastic churn.

        ``nodes`` are ids in the *attach-time* numbering (the ids
        :meth:`on_node_leave` reported via ``self.alive``); default: the
        first ``count`` departed nodes.  The grown fabric is re-probed
        (the joiners have no measurements), full-fabric plan entries
        absorb the joiners — appended to the warm-start order, placed by
        the budgeted refinement — and sub-group entries are left as
        they are.  Fires ``node_join``.  Requires the attach-time
        fabric topology (synthetic kinds); live fleets re-attach.
        """
        self._require_open("handle node join")
        if self._base_fabric is None or self._alive is None:
            raise SessionError(
                "on_node_join needs the attach-time fabric topology to "
                "re-probe the joined nodes; attach a fabric (synthetic "
                "kinds) — live fleets should re-attach instead")
        base_n = self._base_fabric.n
        alive = list(self._alive)
        dead = set(range(base_n)) - set(alive)
        if nodes is None:
            if not dead:
                raise SessionError(
                    "on_node_join: every attach-time node is already live")
            joining = sorted(dead)[:max(1, int(count))]
        else:
            joining = sorted({int(x) for x in nodes})
            bad = [x for x in joining if x not in dead]
            if bad:
                raise ValueError(
                    f"on_node_join ids {bad} are not departed members of "
                    f"the attach-time fabric ({len(alive)}/{base_n} live)")
        if not joining:
            raise ValueError("on_node_join needs at least one node id")
        new_alive = sorted(set(alive) | set(joining))
        new_fabric = self._base_fabric if len(new_alive) == base_n \
            else self._base_fabric.subset(new_alive)
        new_probe = self._probe_fabric(new_fabric)
        pos = {b: i for i, b in enumerate(new_alive)}
        old_to_new = {k: pos[b] for k, b in enumerate(alive)}
        joiners = tuple(pos[b] for b in joining)
        with self._lock:
            self._alive = new_alive
        plan, rungs = self._rebind_membership(
            new_fabric, new_probe, old_to_new, joiners)
        self._fire("node_join", nodes=tuple(joining), joiners=joiners,
                   rungs=rungs, plan=plan)
        return plan

    def _rebind_membership(self, new_fabric: Optional[Fabric],
                           new_probe: ProbeResult,
                           old_to_new: Dict[int, int],
                           joiners: Tuple[int, ...]):
        """Swap fabric+probe after a membership change and warm-recover
        the plan; returns ``(plan, rungs)``."""
        cfg = self.config
        rungs = None
        with self._lock:
            old_plan = self._plan
            self._fabric = new_fabric
            if self._oracle_fabric is not None:
                self._oracle_fabric = new_fabric
            self._probe = new_probe
            self._sparse_fresh = None
            if self._service is not None:   # compiler bound to old oracle
                self._service.close()
                self._service = None
            if self._mesh_shape is not None and \
                    int(np.prod(self._mesh_shape)) != new_probe.n:
                # an N-D assignment cannot survive a node-count change
                self._mesh_shape = None
                self._axis_names = None
            if old_plan is None:
                return None, None
            try:
                new_plan, rungs = recover_plan(
                    old_plan, old_to_new, new_probe.lat, new_probe.bw,
                    hierarchy=getattr(new_probe, "hierarchy", None),
                    joiners=joiners, seed=cfg.solver.seed)
            except Exception as e:
                # keeping a plan whose numbering no longer matches the
                # fabric would be worse than having none: degrade to
                # plan-less (the next plan() recompiles cold)
                self._plan = None
                self._drift = None
                if self._health.force_degraded(
                        f"membership recovery failed: {e!r}") == "degraded":
                    self._safe_fire("degraded", state="degraded",
                                    reason=repr(e))
                return None, None
            self._plan = new_plan
            if self._mix is not None:
                self.cache.put(new_plan, self._mix.key())
            self._drift = DriftMonitor(
                new_plan, self.reference_matrix(),
                cache=self.cache, threshold=cfg.drift.threshold)
            if rungs and any(r in ("stale", "identity")
                             for r in rungs.values()):
                # a rung below warm-resolve means the plan is serving a
                # weaker order than a compile would produce
                if self._health.force_degraded(
                        "membership recovery served a stale/identity "
                        "rung") == "degraded":
                    self._safe_fire("degraded", state="degraded",
                                    reason="ladder")
        return self._plan, rungs

    # -- non-intrusive wrap ------------------------------------------------
    def wrap(self) -> "_WrapGuard":
        """Patch the launch surface so unmodified code gets planned orders.

        * ``repro_torch.launch.mesh.make_production_mesh`` returns the
          session's reordered mesh when its assignment has the production
          shape, and the identity-order mesh otherwise;
        * ``repro_torch.parallel.moe_a2a.arm_ep`` is armed with the
          session's plan whenever the caller passed neither a plan nor a
          session.

        A call site reaches a patch only by looking the function up in its
        module at call time (``moe_a2a.arm_ep(...)``, or an import inside
        the calling function), as the port's own call sites do.  Usable
        as a context manager (``with session.wrap(): ...``); :meth:`unwrap`
        (also run by :meth:`close`) restores the originals.  The paper's
        "no code changes nor rebuild" property, applied to the launchers.
        """
        self._require_open("wrap")
        if self._patches:
            raise SessionError("session is already wrapped")
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.parallel import moe_a2a

        orig_make = mesh_mod.make_production_mesh
        orig_arm = moe_a2a.arm_ep

        def make_production_mesh(*, multi_pod: bool = False,
                                 device: Any = "cuda"):
            plan = self._plan
            if plan is not None and plan.mesh_plan is not None:
                shape, _axes = mesh_mod.production_shape(multi_pod)
                if tuple(plan.mesh_plan.assignment.shape) == tuple(shape):
                    return mesh_mod.make_reordered_mesh(plan.mesh_plan, device)
            return orig_make(multi_pod=multi_pod, device=device)

        def arm_ep(mesh, ep_axis="data", tp_axis="model", plan=None,
                   session=None):
            if plan is None and session is None:
                plan = self._plan
            return orig_arm(mesh, ep_axis, tp_axis, plan=plan, session=session)

        self._patch(mesh_mod, "make_production_mesh", make_production_mesh)
        self._patch(moe_a2a, "arm_ep", arm_ep)
        return _WrapGuard(self)

    def _patch(self, module: Any, attr: str, replacement: Any) -> None:
        self._patches.append((module, attr, getattr(module, attr)))
        setattr(module, attr, replacement)

    def unwrap(self) -> None:
        """Restore every attribute :meth:`wrap` replaced (idempotent)."""
        while self._patches:
            module, attr, original = self._patches.pop()
            setattr(module, attr, original)

    @property
    def wrapped(self) -> bool:
        return bool(self._patches)

    # -- lifecycle: close --------------------------------------------------
    def close(self) -> None:
        """Stop monitoring, unwrap patches, shut the service (idempotent)."""
        if self.state == "closed":
            return
        self._monitor_stop.set()
        t = self._monitor_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self.unwrap()
        with self._lock:
            if self._service is not None:
                self._service.close()
                self._service = None
            self.state = "closed"
        obs.metrics().counter("session.closes").inc()
        self._export_obs()
        self._fire("close")

    def _export_obs(self) -> None:
        """Write configured obs artifacts (trace / capture) on close.

        Export failures warn instead of raising: close() must stay
        usable from error paths and __exit__.
        """
        cfg = self.config.obs
        if cfg.export_path:
            try:
                obs.tracer().export(cfg.export_path)
            except Exception as e:
                warnings.warn(
                    f"session could not export the obs trace to "
                    f"{cfg.export_path!r} ({e!r})",
                    RuntimeWarning, stacklevel=3)
        if cfg.capture_path:
            try:
                obs.recorder().trace(name="session").save(cfg.capture_path)
            except Exception as e:
                warnings.warn(
                    f"session could not save the workload capture to "
                    f"{cfg.capture_path!r} ({e!r})",
                    RuntimeWarning, stacklevel=3)
