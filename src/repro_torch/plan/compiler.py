"""Collective plan compiler: joint (algorithm, chunking, rank order) selection.

A copy of ``repro.plan.compiler``.  The paper's pipeline optimizes one
collective at a time, but a real job issues a *mix* of all-reduce /
all-gather / reduce-scatter / all-to-all at many message sizes, and the
best (algorithm, chunk count, rank permutation) differs per op and size
band (PCCL, Won et al.; the MCF reformulation, Arzani et al.).  This
module compiles the whole mix once:

* a :class:`JobMix` declares the collectives a job issues, by hand or
  from optimized HLO text (:meth:`JobMix.from_hlo`);
* :class:`PlanCompiler` enumerates, per (collective, message-size bucket,
  process group), every feasible registered builder from
  :mod:`repro_torch.collective`, compiles each into a typed ``Program``,
  solves a rank permutation with the vectorized solver
  (:func:`repro_torch.core.solver.solve`) and applies it as an IR pass, and
  scores the candidate programs through the executors —
  :class:`repro_torch.collective.SimExecutor` (contention-aware oracle) with
  a fabric, :class:`repro_torch.collective.AnalyticExecutor` without one
  (live probing on real hardware);
* the result is a :class:`Plan`: a JSON-serializable table of
  :class:`PlanEntry` rows plus an optional N-D :class:`MeshPlan`, keyed
  by the fabric fingerprint it was compiled against (see
  :mod:`repro_torch.plan.cache`).

Message sizes are bucketed per octave (log2) so a job's histogram folds
into a handful of entries and cache keys stay canonical.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.collective import (
    AnalyticExecutor,
    CollectiveOp,
    Program,
    SimExecutor,
    apply_permutation,
    candidates as builder_candidates,
    chunk as chunk_pass,
    compile_op,
    get_builder,
    kind_from_op,
)
from repro_torch.core.cost_models import make_cost_model
from repro_torch.core.reorder import (
    MeshPlan,
    hierarchical_perm,
    mesh_axis_cost,
    optimize_mesh_assignment,
)
from repro_torch.core.solver import solve
from repro_torch.fabric import Fabric, HierarchyModel, ProbeResult, combine_cost

__all__ = [
    "CollectiveRequest",
    "JobMix",
    "PlanEntry",
    "Plan",
    "PlanCompiler",
    "SolveBudget",
    "candidate_algorithms",
    "size_bucket",
]

#: Collective ops the compiler plans for.  ``collective-permute`` is
#: deliberately absent: it is already an explicit point-to-point schedule,
#: so there is no algorithm choice to make.
PLANNED_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

def candidate_algorithms(op: str, n: int,
                         lowerable_only: bool = False,
                         ) -> List[Tuple[str, Dict[str, int]]]:
    """Feasible (builder name, builder kwargs) pairs for ``op`` at size n.

    Thin alias over :func:`repro_torch.collective.candidates`: power-of-two
    builders are gated on n via each builder's ``feasible`` contract;
    bcube prefers base 4 when n is a power of 4, else base 2.

    With ``lowerable_only`` the list is additionally filtered to
    algorithms :class:`repro_torch.collective.ScheduleLowering` can lower
    to a permute schedule — every registered builder, since the lowering
    is total over round-based programs.
    """
    if op not in PLANNED_OPS:
        return []
    cands = builder_candidates(op, n)
    if lowerable_only:
        from repro_torch.collective import registered_builders
        lowerable = set(registered_builders())
        cands = [(a, kw) for a, kw in cands if a in lowerable]
    return cands


def size_bucket(size_bytes: float) -> int:
    """Octave bucket id: floor(log2(size)).  Sizes < 1 byte collapse to 0."""
    return int(np.floor(np.log2(max(float(size_bytes), 1.0))))


@dataclasses.dataclass(frozen=True)
class CollectiveRequest:
    """One line of a job's collective histogram."""

    op: str                                  # one of PLANNED_OPS
    size_bytes: float                        # per-call payload
    count: float = 1.0                       # calls per step / per query
    group: Optional[Tuple[int, ...]] = None  # node ids; None = all nodes

    def __post_init__(self):
        if self.op not in PLANNED_OPS:
            raise ValueError(f"unknown collective op {self.op!r}; "
                             f"expected one of {PLANNED_OPS}")


@dataclasses.dataclass(frozen=True)
class JobMix:
    """The collective mix one job issues (its message-size histogram)."""

    requests: Tuple[CollectiveRequest, ...]
    name: str = "job"

    def __post_init__(self):
        object.__setattr__(self, "requests", tuple(self.requests))

    def key(self) -> str:
        """Canonical cache/dedup key: bucketed, sorted, group-explicit."""
        rows = sorted(
            (r.op, size_bucket(r.size_bytes),
             list(r.group) if r.group is not None else [])
            for r in self.requests
        )
        return json.dumps(rows, separators=(",", ":"))

    @staticmethod
    def from_hlo(hlo_text: str, name: str = "hlo",
                 scale_loops: bool = True) -> "JobMix":
        """Build a mix from optimized HLO text.

        Wraps :func:`repro_torch.launch.hlo_analysis.parse_collectives`;
        each detail row (comp, op, total_bytes, multiplier) becomes a
        request of ``total_bytes / multiplier`` per call, ``multiplier``
        calls.  ``collective-permute`` rows are skipped (no algorithm
        choice), as are rows of zero bytes or zero multiplier.
        """
        from repro_torch.launch.hlo_analysis import parse_collectives

        stats = parse_collectives(hlo_text, scale_loops=scale_loops)
        reqs = []
        for _comp, op, total_bytes, mult in stats.details:
            if op not in PLANNED_OPS or total_bytes <= 0 or mult <= 0:
                continue
            reqs.append(CollectiveRequest(
                op=op, size_bytes=total_bytes / mult, count=float(mult)))
        return JobMix(requests=tuple(reqs), name=name)


@dataclasses.dataclass
class PlanEntry:
    """The compiled choice for one (op, size bucket, process group).

    The canonical artifact is the typed ``Program`` the compiler scored
    (rebuildable via :meth:`program`, identity-checked by
    ``program_fingerprint``).  The ``(algo, chunks, perm)`` string-tuple
    fields remain as a deprecating alias of that program — kept for
    JSON compatibility and human-readable plan dumps; new consumers
    should go through :meth:`program` and the Executor protocol.
    """

    op: str
    bucket: int
    size_bytes: float                 # representative payload of the bucket
    group: Tuple[int, ...]            # global node ids, sorted
    algo: str                         # registered repro_torch.collective builder
    algo_kwargs: Dict[str, int]       # e.g. {"base": 4} for bcube
    chunks: int                       # payload split into this many pipelined pieces
    perm: Tuple[int, ...]             # perm[rank] = global node id
    expected_time: float              # oracle seconds per call for the choice
    identity_times: Dict[str, float]  # algo -> oracle seconds at identity order, chunks=1
    solver_cost: float                # cost-model objective of perm
    oracle: str                       # "simulator" | "cost_model"
    program_fingerprint: str = ""     # Program.fingerprint() of the choice
    #: planned overlap-bucket payload (bytes) for this octave: the size
    #: the gradient-bucketing layer (``repro_torch.train.overlap_grads``)
    #: should split a payload of this entry's octave into when fusing
    #: the collective with compute.  0.0 = not planned for this op.
    bucket_bytes: float = 0.0

    @property
    def local_perm(self) -> np.ndarray:
        """perm expressed as positions within ``group`` (rank -> index)."""
        pos = {node: i for i, node in enumerate(self.group)}
        return np.asarray([pos[node] for node in self.perm], dtype=np.int64)

    @property
    def best_identity_time(self) -> float:
        return min(self.identity_times.values())

    def program(self) -> Program:
        """Rebuild the typed ``Program`` this entry's choice denotes.

        Deterministic: compile the registered builder, apply the stored
        permutation and chunking as IR passes.  The result's
        ``fingerprint()`` matches ``program_fingerprint`` for entries
        compiled by this version (older cached plans carry ``""``).
        """
        op = CollectiveOp(kind_from_op(self.op), self.size_bytes, self.group)
        prog = compile_op(op, self.algo, **self.algo_kwargs)
        prog = apply_permutation(prog, self.perm)
        if self.chunks > 1:
            prog = chunk_pass(prog, self.chunks)
        return prog

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["group"] = list(self.group)
        d["perm"] = list(self.perm)
        return d

    @staticmethod
    def from_dict(d: dict) -> "PlanEntry":
        return PlanEntry(
            op=d["op"], bucket=int(d["bucket"]),
            size_bytes=float(d["size_bytes"]),
            group=tuple(int(x) for x in d["group"]),
            algo=d["algo"],
            algo_kwargs={k: int(v) for k, v in d["algo_kwargs"].items()},
            chunks=int(d["chunks"]),
            perm=tuple(int(x) for x in d["perm"]),
            expected_time=float(d["expected_time"]),
            identity_times={k: float(v) for k, v in d["identity_times"].items()},
            solver_cost=float(d["solver_cost"]),
            oracle=d["oracle"],
            program_fingerprint=d.get("program_fingerprint", ""),
            bucket_bytes=float(d.get("bucket_bytes", 0.0)),
        )


EntryKey = Tuple[str, int, Tuple[int, ...]]


@dataclasses.dataclass
class Plan:
    """A compiled collective plan for one fabric + one job mix."""

    fingerprint: "FabricFingerprint"          # see repro_torch.plan.cache
    n: int
    entries: Dict[EntryKey, PlanEntry]
    mesh_plan: Optional[MeshPlan]
    compile_seconds: float
    mix_key: str
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    # -- queries ----------------------------------------------------------
    def _norm_group(self, group: Optional[Sequence[int]]) -> Tuple[int, ...]:
        if group is None:
            return tuple(range(self.n))
        return tuple(sorted(int(g) for g in group))

    def lookup(self, op: str, size_bytes: float,
               group: Optional[Sequence[int]] = None) -> Optional[PlanEntry]:
        """Entry for ``op`` at the nearest size bucket for ``group``."""
        g = self._norm_group(group)
        want = size_bucket(size_bytes)
        best, best_d = None, None
        for (eop, bucket, eg), entry in self.entries.items():
            if eop != op or eg != g:
                continue
            d = abs(bucket - want)
            if best_d is None or d < best_d:
                best, best_d = entry, d
        return best

    def total_time(self, mix: JobMix) -> float:
        """Oracle seconds for one pass over the mix under this plan."""
        total = 0.0
        for r in mix.requests:
            e = self.lookup(r.op, r.size_bytes, r.group)
            if e is not None:
                total += r.count * e.expected_time
        return total

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        from .cache import FabricFingerprint  # local: cache imports compiler

        assert isinstance(self.fingerprint, FabricFingerprint)
        d = {
            "version": 1,
            "fingerprint": self.fingerprint.to_dict(),
            "n": self.n,
            "entries": [e.to_dict() for e in self.entries.values()],
            "mesh_plan": None,
            "compile_seconds": self.compile_seconds,
            "mix_key": self.mix_key,
            "meta": self.meta,
        }
        if self.mesh_plan is not None:
            mp = self.mesh_plan
            d["mesh_plan"] = {
                "assignment": mp.assignment.tolist(),
                "axis_names": list(mp.axis_names),
                "cost": mp.cost,
                "baseline_cost": mp.baseline_cost,
                "per_axis": dict(mp.per_axis),
            }
        return json.dumps(d, indent=1)

    @staticmethod
    def from_json(s: str) -> "Plan":
        from .cache import FabricFingerprint

        d = json.loads(s)
        entries = {}
        for ed in d["entries"]:
            e = PlanEntry.from_dict(ed)
            entries[(e.op, e.bucket, e.group)] = e
        mesh_plan = None
        if d.get("mesh_plan"):
            mp = d["mesh_plan"]
            mesh_plan = MeshPlan(
                assignment=np.asarray(mp["assignment"], dtype=np.int64),
                axis_names=tuple(mp["axis_names"]),
                cost=float(mp["cost"]),
                baseline_cost=float(mp["baseline_cost"]),
                per_axis={k: float(v) for k, v in mp["per_axis"].items()},
            )
        return Plan(
            fingerprint=FabricFingerprint.from_dict(d["fingerprint"]),
            n=int(d["n"]),
            entries=entries,
            mesh_plan=mesh_plan,
            compile_seconds=float(d["compile_seconds"]),
            mix_key=d["mix_key"],
            meta=dict(d.get("meta", {})),
        )


@dataclasses.dataclass(frozen=True)
class SolveBudget:
    """Solver effort per entry; the service shares one compile across
    jobs, so a few seconds of compile buys every consumer."""

    iters: int = 800
    chains: int = 8
    chunk_candidates: Tuple[int, ...] = (1, 2, 4)
    #: don't bother chunking payloads below this (latency-bound regime)
    min_chunk_bytes: float = 64 * 1024
    #: forwarded to :func:`repro_torch.core.solver.solve`
    engine: str = "vectorized"          # "vectorized" | "reference"
    backend: str = "numpy"              # "numpy" | "jax" (the batched evaluator)
    #: groups at least this large solve by hierarchy decomposition
    #: (per-cluster then inter-cluster) when a recovered
    #: :class:`repro_torch.fabric.HierarchyModel` is available — the flat SA
    #: search is the compile bottleneck at fleet scale
    hierarchy_min_n: int = 48
    #: candidate overlap-bucket payloads (bytes) scored per all-reduce
    #: entry; the octave's own size always joins as the single-bucket
    #: candidate
    bucket_candidates: Tuple[int, ...] = (1 << 18, 1 << 20, 1 << 22)


class PlanCompiler:
    """Compile a :class:`Plan` from a probe (or fabric) and a job mix.

    ``fabric``, when given, is the contention-aware oracle every
    candidate is validated against (offline: the synthetic "real cloud").
    Without it — live probing on hardware we cannot simulate — candidates
    are scored by their analytic cost model, which the reference's
    Table-I reproduction showed rank-correlates with the simulator.
    """

    def __init__(self, fabric: Optional[Fabric] = None,
                 budget: Optional[SolveBudget] = None, seed: int = 0,
                 device: Any = "cuda"):
        self.fabric = fabric
        self.budget = budget or SolveBudget()
        self.seed = seed
        #: where ``budget.backend="jax"`` evaluates (unused by "numpy")
        self.device = device
        # static-verification verdicts, keyed by the program's schedule
        # *structure* (see _verify_key): size- and placement-invariant,
        # so one verify covers every bucket/group reusing the same
        # candidate — but rewrite passes that change the rounds
        # (chunking, fusion) get their own verdict
        self._verify_cache: Dict[Tuple, bool] = {}

    # -- static verification gate -----------------------------------------
    @staticmethod
    def _verify_key(program) -> Tuple:
        """Cache key of a program's structural verdict.

        The gate passes analyze rank space and never read ``perm``, so
        the verdict is placement- and payload-size-invariant — but it
        is NOT rewrite-invariant: ``chunk`` changes ``chunk_factor``
        and ``fuse_rounds`` changes the round structure, and replaying
        an unchunked/unfused verdict for the rewritten program would
        skip verifying what actually ships (an earlier key of the
        reference did exactly that).  The rewrite-pass signature ``(chunk_factor, number of
        rounds)`` distinguishes every rewrite the compiler applies
        today; anything more invasive changes the fingerprint-bearing
        rounds and should not share a verdict anyway.
        """
        return (program.algorithm, program.algo_kwargs, program.op.kind,
                program.n, program.chunk_factor, len(program.rounds))

    def _verify_gate(self, program, *, stage: str, cache: bool = True) -> None:
        """Hard gate: raise :class:`repro_torch.analysis.VerificationError` on
        any error-level finding; warnings surface as obs events.

        ``GATE_PASSES`` includes the ``equiv`` translation validator,
        so passing the gate also certifies the program's permute
        lowering against its IR."""
        from repro_torch.analysis import GATE_PASSES, require_valid

        key = self._verify_key(program)
        if cache and self._verify_cache.get(key):
            return
        report = require_valid(program, passes=GATE_PASSES)
        m = obs.metrics()
        m.counter("plan.verify.programs").inc()
        for f in report.by_severity("warning"):
            m.counter("plan.verify.warnings").inc()
            obs.tracer().event("plan.verify.warning", stage=stage,
                              algo=program.algorithm, code=f.code,
                              message=f.message)
        if cache:
            self._verify_cache[key] = True

    # -- inputs -----------------------------------------------------------
    @staticmethod
    def _matrices(probe) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(lat, bw) from a ProbeResult, Fabric, or plain cost matrix."""
        if isinstance(probe, ProbeResult):
            return probe.lat, probe.bw
        if isinstance(probe, Fabric):
            return probe.lat, probe.bw
        c = np.asarray(probe, dtype=np.float64)
        assert c.ndim == 2 and c.shape[0] == c.shape[1]
        return c, None

    def _model(self, algo: str, lat, bw, size_bytes: float,
               akw: Dict[str, int]):
        """Cost model the solver optimizes the rank order with (the
        oracle executor then scores the *actual* program)."""
        m_algo = get_builder(algo).cost_model
        kwargs = {"base": akw["base"]} if "base" in akw else {}
        if bw is not None:
            return make_cost_model(m_algo, size_bytes=size_bytes,
                                   lat=lat, bw=bw, **kwargs)
        # paper mode: one latency-centric matrix, rounds rescale linearly
        return make_cost_model(m_algo, cost_matrix=lat,
                               size_bytes=size_bytes, **kwargs)

    # -- oracle -----------------------------------------------------------
    def _oracle(self, lat, bw):
        """The Executor candidates are scored on: the contention-aware
        simulator when a fabric is attached, the analytic cost-model
        math otherwise (live probing on hardware we cannot simulate)."""
        if self.fabric is not None:
            return SimExecutor(self.fabric)
        if bw is not None:
            return AnalyticExecutor(lat=lat, bw=bw)
        return AnalyticExecutor(cost_matrix=lat)

    # -- compilation ------------------------------------------------------
    def compile(self, probe, mix: JobMix,
                mesh_shape: Optional[Sequence[int]] = None,
                axis_names: Optional[Sequence[str]] = None,
                fingerprint=None,
                hierarchy: Optional[HierarchyModel] = None) -> Plan:
        """Compile the plan; ``hierarchy`` (or ``probe.hierarchy``, which
        the reference's sparse probe result carries) switches large
        groups to hierarchy-decomposed solving and the fingerprint to the
        tree sketch."""
        # the obs timer is the one wall-clock source: always measures
        # (compile_seconds is a product number) and lands in the trace
        # whenever tracing is enabled
        timer = obs.tracer().timer("plan.compile", mix=mix.name)
        with timer:
            plan = self._compile_body(probe, mix, mesh_shape, axis_names,
                                        fingerprint, hierarchy)
            timer.set(entries=len(plan.entries))
        plan.compile_seconds = timer.elapsed
        m = obs.metrics()
        m.counter("plan.compiles").inc()
        m.histogram("plan.compile.seconds", scale=1e-3).observe(timer.elapsed)
        return plan

    def _compile_body(self, probe, mix: JobMix, mesh_shape, axis_names,
                        fingerprint, hierarchy) -> Plan:
        from .cache import fabric_fingerprint

        lat, bw = self._matrices(probe)
        n = lat.shape[0]
        if hierarchy is None:
            hierarchy = getattr(probe, "hierarchy", None)
        if hierarchy is not None and hierarchy.n != n:
            raise ValueError(
                f"hierarchy covers {hierarchy.n} nodes but the probe has "
                f"{n}; probe and hierarchy must describe the same fabric")
        if fingerprint is None:
            fingerprint = fabric_fingerprint(lat, bw, hierarchy=hierarchy)

        # Merge requests into (op, bucket, group) cells; the compile size
        # is the count-weighted geometric mean of the cell's sizes.
        cells: Dict[EntryKey, List[CollectiveRequest]] = {}
        for r in mix.requests:
            g = tuple(sorted(r.group)) if r.group is not None else tuple(range(n))
            if any(x < 0 or x >= n for x in g):
                raise ValueError(f"request group {g} outside fabric of {n} nodes")
            cells.setdefault((r.op, size_bucket(r.size_bytes), g), []).append(r)

        entries: Dict[EntryKey, PlanEntry] = {}
        for (op, bucket, group), reqs in sorted(cells.items()):
            w = np.asarray([r.count for r in reqs])
            s = np.asarray([r.size_bytes for r in reqs])
            repr_size = float(np.exp(np.average(np.log(np.maximum(s, 1.0)),
                                                weights=np.maximum(w, 1e-9))))
            with obs.tracer().span("plan.compile_entry", op=op,
                                   bucket=bucket, n=len(group)) as sp:
                entry = self._compile_entry(
                    op, bucket, group, repr_size, lat, bw, hierarchy)
                sp.set(algo=entry.algo, chunks=entry.chunks)
            entries[(op, bucket, group)] = entry

        mesh_plan = None
        if mesh_shape is not None:
            axis_names = tuple(axis_names or
                               ("pod", "data", "model")[-len(tuple(mesh_shape)):])
            # Mesh objective at the mix's dominant payload: lat + S/bw when
            # bandwidth was probed — multi-MB payloads are bw-dominated on
            # accelerator fabrics (see topology.Fabric.cost_matrix).
            mesh_payload = max((r.size_bytes for r in mix.requests), default=0.0)
            c_mesh = lat.copy()
            if bw is not None and mesh_payload:
                with np.errstate(divide="ignore"):
                    c_mesh = c_mesh + mesh_payload / bw
            np.fill_diagonal(c_mesh, 0.0)
            c_mesh = np.maximum(c_mesh, c_mesh.T)
            mesh_plan = optimize_mesh_assignment(
                c_mesh, tuple(mesh_shape), axis_names, seed=self.seed,
                hierarchy=hierarchy)
            if mesh_plan.cost > mesh_plan.baseline_cost:
                # the heuristic can lose to identity on tiny/uniform
                # fabrics; a compiled plan must never ship a regression
                ident = np.arange(n, dtype=np.int64).reshape(tuple(mesh_shape))
                mesh_plan = MeshPlan(
                    assignment=ident, axis_names=axis_names,
                    cost=mesh_plan.baseline_cost,
                    baseline_cost=mesh_plan.baseline_cost,
                    per_axis={axis_names[a]: mesh_axis_cost(ident, c_mesh, a)
                              for a in range(len(axis_names))})

        return Plan(
            fingerprint=fingerprint,
            n=n,
            entries=entries,
            mesh_plan=mesh_plan,
            compile_seconds=0.0,        # stamped by compile()'s obs timer
            mix_key=mix.key(),
            meta={
                "mix_name": mix.name,
                "oracle": "simulator" if self.fabric is not None else "cost_model",
                "budget": dataclasses.asdict(self.budget),
                "hierarchy": hierarchy.to_dict() if hierarchy is not None
                             else None,
            },
        )

    def _compile_entry(self, op: str, bucket: int, group: Tuple[int, ...],
                       size_bytes: float, lat, bw,
                       hierarchy: Optional[HierarchyModel] = None) -> PlanEntry:
        g = np.asarray(group, dtype=np.int64)
        n_g = len(g)
        sub_lat = lat[np.ix_(g, g)]
        sub_bw = bw[np.ix_(g, g)] if bw is not None else None
        use_sim = self.fabric is not None
        oracle_name = "simulator" if use_sim else "cost_model"
        executor = self._oracle(lat, bw) if use_sim else None
        coll_op = CollectiveOp(kind_from_op(op), size_bytes, group)

        # Hierarchy decomposition: one locality-nested permutation per
        # entry (solve per cluster, then inter-cluster over supernodes)
        # replaces the per-algorithm flat SA search — the permutation is
        # pure locality nesting, so every candidate algorithm scores the
        # same one under its own cost model.
        hier_local: Optional[np.ndarray] = None
        if hierarchy is not None and not hierarchy.flat \
                and n_g >= self.budget.hierarchy_min_n:
            sub_h = hierarchy.restrict(group)
            if not sub_h.flat:
                hier_local = hierarchical_perm(
                    combine_cost(sub_lat, sub_bw, size_bytes), sub_h,
                    seed=self.seed)

        best = None          # (time, algo, akw, chunks, perm, mcost)
        identity_times: Dict[str, float] = {}
        identity_local = np.arange(n_g)
        # Chunking is scored as serial pieces, and the analytic cost
        # models are affine in payload — so without the contention-aware
        # simulator (whose fair-share rates are nonlinear) chunks > 1 is
        # mathematically dominated by chunks=1: skip the wasted oracles.
        chunk_cands = self.budget.chunk_candidates if use_sim else (1,)
        for algo, akw in candidate_algorithms(op, n_g):
            model = self._model(algo, sub_lat, sub_bw, size_bytes, akw)
            # Programs are only materialized when the oracle reads their
            # rounds (the simulator): the analytic oracle is the same
            # closed-form math as ``model`` at chunks=1, and building
            # every candidate's rounds just to discard them dominates
            # large-fleet compiles (bcube at n=1024 is ~1M flows).
            base_prog = compile_op(coll_op, algo, **akw) if use_sim else None
            if base_prog is not None:
                # gate every candidate the oracle will score; the verdict
                # is structural, so it caches across buckets and groups
                self._verify_gate(base_prog, stage="candidate")
            if hier_local is not None:
                solved_local = hier_local
            else:
                solved = solve(model, method="auto", iters=self.budget.iters,
                               chains=self.budget.chains, seed=self.seed,
                               engine=self.budget.engine,
                               backend=self.budget.backend,
                               device=self.device)
                solved_local = np.asarray(solved.perm)
            for local in (identity_local, solved_local):
                node_perm = g[local]
                placed = apply_permutation(base_prog, node_perm) \
                    if use_sim else None
                for chunks in chunk_cands:
                    if chunks > 1 and size_bytes / chunks < self.budget.min_chunk_bytes:
                        continue
                    if use_sim:
                        t = executor.estimate(chunk_pass(placed, chunks))
                    else:
                        # == AnalyticExecutor.estimate on the candidate
                        # program (equivalence-tested), minus the rounds
                        t = float(model.cost(local))
                    if local is identity_local and chunks == 1:
                        identity_times[algo] = t
                    cand = (t, algo, akw, chunks, node_perm,
                            float(model.cost(local)))
                    if best is None or t < best[0]:
                        best = cand

        assert best is not None, f"no feasible algorithm for {op} over {n_g} nodes"
        t, algo, akw, chunks, node_perm, mcost = best
        winner = chunk_pass(
            apply_permutation(compile_op(coll_op, algo, **akw), node_perm),
            chunks)
        # the winner ships: verify it even in analytic mode (where no
        # candidate was gated).  The winner's key carries its rewrite
        # signature, so a chunked winner never reuses the unchunked
        # candidate verdict — it earns (and caches) its own
        self._verify_gate(winner, stage="winner")
        pos = {int(node): i for i, node in enumerate(g)}
        winner_local = np.asarray([pos[int(x)] for x in node_perm],
                                  dtype=np.int64)
        return PlanEntry(
            op=op, bucket=bucket, size_bytes=size_bytes, group=group,
            algo=algo, algo_kwargs=dict(akw), chunks=chunks,
            perm=tuple(int(x) for x in node_perm),
            expected_time=float(t), identity_times=identity_times,
            solver_cost=mcost, oracle=oracle_name,
            program_fingerprint=winner.fingerprint(),
            bucket_bytes=self._select_bucket_bytes(
                op, algo, akw, sub_lat, sub_bw, winner_local, size_bytes),
        )

    def _select_bucket_bytes(self, op: str, algo: str, akw: Dict[str, int],
                             sub_lat, sub_bw, local: np.ndarray,
                             size_bytes: float) -> float:
        """Overlap-bucket payload for this octave (all-reduce only).

        Scores each candidate bucket size ``b`` by the pipeline-makespan
        lower bound of running ``ceil(S / b)`` back-to-back schedules
        fused with compute: the first bucket's transfer is fully exposed
        (pipeline fill) and every later bucket still exposes its latency
        floor — the per-round issue cost that serializes with the
        applies even when bandwidth hides behind compute::

            score(b) = t(b) + (ceil(S / b) - 1) * t_latency_only

        Small buckets shrink the exposed fill but multiply the latency
        floor; large buckets amortize latency but leave a long fill.
        The winner's *analytic* model prices both terms — bucketing is a
        pipelining tradeoff, where the affine alpha-beta form suffices
        even when the entry itself was scored on the simulator (pricing
        ~4 extra programs per entry on the simulator would dominate
        compile time at fleet scale for no ranking change).
        """
        if op != "all-reduce" or size_bytes <= 0:
            return 0.0
        t_lat = float(self._model(algo, sub_lat, sub_bw, 0.0, akw)
                      .cost(local))
        cands = sorted(
            {float(b) for b in self.budget.bucket_candidates
             if 0 < b < size_bytes} | {float(size_bytes)},
            reverse=True)     # ties go to the larger bucket
        best_b, best_score = cands[0], None
        for b in cands:
            n_buckets = int(np.ceil(size_bytes / b))
            t_b = float(self._model(algo, sub_lat, sub_bw, b, akw)
                        .cost(local))
            score = t_b + (n_buckets - 1) * t_lat
            if best_score is None or score < best_score:
                best_b, best_score = b, score
        return best_b
