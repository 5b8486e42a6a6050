"""Unified, declarative session configuration (a copy of
``repro.session.config``).

Every knob that was previously hand-threaded through ``core`` / ``plan``
/ ``launch`` call sites lives here as one frozen dataclass tree:

* :class:`FabricConfig` — which fabric to attach (synthetic datacenter /
  TPU fleet; live device probing is not ported yet and raises);
* :class:`ProbeConfig` — paper §IV-B probing parameters;
* :class:`SolverConfig` — solver seed + :class:`repro_torch.plan.SolveBudget`
  (iters, chains, chunk candidates, engine, backend);
* :class:`CacheConfig` — plan-cache directory / capacity / fuzzy-match
  tolerance;
* :class:`DriftConfig` — drift threshold and re-plan policy;
* :class:`repro_torch.faults.RetryPolicy` — probe/re-plan backoff and the
  monitor's degraded/halted health thresholds (the ``retry`` section);
* :class:`MeshConfig` — N-D mesh shape + axis names;
* :class:`ObsConfig` — observability: tracing on/off + ring-buffer
  size, workload capture, metrics, and export paths (see
  :mod:`repro_torch.obs`);
* :class:`OverlapConfig` — compute–communication overlap mode and
  bucket-size override for the certified train step (see
  :mod:`repro_torch.train.overlap_grads`).

The tree round-trips through plain dicts (:meth:`SessionConfig.to_dict`
/ :meth:`SessionConfig.from_dict`), JSON files (:meth:`SessionConfig.load`
/ :meth:`SessionConfig.dump`), and the environment
(:meth:`SessionConfig.from_env`, ``REPRO_<SECTION>_<FIELD>`` variables),
so the same declaration drives the Python API, ``python -m repro_torch``
and launcher scripts.  The variables keep the reference's ``REPRO_``
prefix, so one environment configures both packages alike.

One field differs from the reference: :class:`OverlapConfig` carries
``use_kernel_add`` (default on, the ``fused_add`` CUDA kernel) where the
reference has ``use_pallas_add`` (default off).  The reference's spelling
is read as an alias, in a dict and in the environment
(``REPRO_OVERLAP_USE_PALLAS_ADD``), so a config the reference dumped loads
here; given both spellings with different values, loading raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.faults.retry import RetryPolicy
from repro_torch.plan.cache import DEFAULT_TOL
from repro_torch.plan.compiler import SolveBudget

__all__ = [
    "FabricConfig",
    "ProbeConfig",
    "SolverConfig",
    "CacheConfig",
    "DriftConfig",
    "MeshConfig",
    "ObsConfig",
    "OverlapConfig",
    "RetryPolicy",
    "SessionConfig",
]


def _parse_dims(value: Any) -> Tuple[int, ...]:
    """Accept (8, 8), [8, 8], "8x8", or "8,8"."""
    if value is None:
        return ()
    if isinstance(value, str):
        sep = "x" if "x" in value else ","
        parts = [p for p in value.split(sep) if p.strip()]
        return tuple(int(p) for p in parts)
    return tuple(int(v) for v in value)


def _parse_names(value: Any) -> Tuple[str, ...]:
    if value is None:
        return ()
    if isinstance(value, str):
        return tuple(p.strip() for p in value.split(",") if p.strip())
    return tuple(str(v) for v in value)


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Which fabric a session attaches to when none is passed explicitly."""

    kind: str = "datacenter"           # "datacenter" | "tpu-fleet" | "live"
    nodes: int = 64                    # datacenter size
    n_pods: int = 1                    # tpu-fleet pods
    pod_shape: Tuple[int, ...] = (8, 8)
    fragmentation: float = 0.0
    seed: int = 0
    #: scramble the node labels (the cloud's "random IP list", paper §I);
    #: None = no scramble
    scramble_seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "pod_shape", _parse_dims(self.pod_shape))
        if self.kind not in ("datacenter", "tpu-fleet", "live"):
            raise ValueError(
                f"FabricConfig.kind must be 'datacenter', 'tpu-fleet', or "
                f"'live'; got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Paper §IV-B probing parameters (see :func:`repro_torch.fabric.probe_fabric`).

    ``mode="sparse"`` switches to budgeted probing
    (:func:`repro_torch.fabric.sparse_probe_fabric`): ``budget`` of the dense
    n(n-1) probes reconstructs a plan-grade cost matrix and recovers
    the locality hierarchy, which the compiler then exploits.
    """

    n_probes: int = 1000
    percentile: float = 10.0
    noise_scale: float = 0.3
    measure_bw: bool = True
    seed: int = 0
    mode: str = "dense"                # "dense" | "sparse"
    budget: float = 0.25               # sparse probe fraction of n(n-1)

    def __post_init__(self):
        if self.mode not in ("dense", "sparse"):
            raise ValueError(
                f"ProbeConfig.mode must be 'dense' or 'sparse'; "
                f"got {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver engine selection + per-entry effort budget."""

    seed: int = 0
    budget: SolveBudget = dataclasses.field(default_factory=SolveBudget)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Plan-cache policy (see :class:`repro_torch.plan.PlanCache`)."""

    dir: Optional[str] = None          # None = in-memory only
    capacity: int = 32
    tol: float = DEFAULT_TOL           # fuzzy fingerprint-match octaves


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """When an observed cost matrix invalidates the current plan."""

    threshold: float = 1.15            # degradation ratio triggering repair
    auto_replan: bool = True           # recompile after a stale observation
    interval_s: float = 5.0            # background monitor poll period


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """N-D mesh the plan's assignment targets; empty = no mesh plan."""

    shape: Tuple[int, ...] = ()
    axis_names: Tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "shape", _parse_dims(self.shape))
        names = _parse_names(self.axis_names)
        if self.shape and not names:
            names = ("pod", "data", "model")[-len(self.shape):]
        object.__setattr__(self, "axis_names", names)
        if self.shape and len(names) != len(self.shape):
            raise ValueError(
                f"MeshConfig needs one axis name per dim: shape {self.shape} "
                f"vs axis_names {names}")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability switches (see :mod:`repro_torch.obs`).

    A session applies this section to the process-global tracer /
    metrics registry / workload recorder on attach
    (:func:`repro_torch.obs.configure`); the env overlay spells it
    ``REPRO_OBS_ENABLED=1``, ``REPRO_OBS_CAPTURE=1``,
    ``REPRO_OBS_EXPORT_PATH=trace.json`` etc.
    """

    enabled: bool = False              # span/event tracing
    buffer: int = 8192                 # tracer ring-buffer records
    metrics: bool = True               # counter/gauge/histogram registry
    capture: bool = False              # workload (op, bytes, group, t) capture
    #: write the Chrome trace here on Session.close() (None = don't)
    export_path: Optional[str] = None
    #: write the captured WorkloadTrace JSON here on Session.close()
    capture_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Compute–communication overlap of the certified collective path.

    Consumed by ``Session.overlap_step`` and the train layer
    (:mod:`repro_torch.train.overlap_grads`): ``mode`` selects how the
    bucketed gradient all-reduce interleaves with compute, and
    ``bucket_bytes`` overrides the plan-selected bucket payload
    (``0`` = use :attr:`repro_torch.plan.PlanEntry.bucket_bytes`).  Env
    overlay: ``REPRO_OVERLAP_MODE=bucketed`` etc.
    """

    mode: str = "off"            # "off" | "sequential" | "bucketed" | "fused"
    #: bucket payload override (bytes); 0 = planned per octave
    bucket_bytes: float = 0.0
    #: mesh axis the bucketed all-reduce runs over
    axis: str = "data"
    #: reduce through the fused_add CUDA kernel (runner transport)
    use_kernel_add: bool = True

    def __post_init__(self):
        if self.mode not in ("off", "sequential", "bucketed", "fused"):
            raise ValueError(
                f"OverlapConfig.mode must be 'off', 'sequential', "
                f"'bucketed', or 'fused'; got {self.mode!r}")


_SECTIONS: Dict[str, type] = {
    "fabric": FabricConfig,
    "probe": ProbeConfig,
    "solver": SolverConfig,
    "cache": CacheConfig,
    "drift": DriftConfig,
    "retry": RetryPolicy,
    "mesh": MeshConfig,
    "obs": ObsConfig,
    "overlap": OverlapConfig,
}


#: the reference's field names the port renamed: section class -> alias -> field
_ALIASES: Dict[type, Dict[str, str]] = {
    OverlapConfig: {"use_pallas_add": "use_kernel_add"},
}


def _coerce(ftype: Any, value: Any) -> Any:
    """Best-effort string coercion for env/CLI-sourced values."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    if s.lower() in ("none", "null"):
        return None
    if ftype is int:
        return int(float(s))
    if ftype is float:
        return float(s)
    if ftype is bool:
        return s.lower() in ("1", "true", "yes", "on")
    return s


def _field_hint(f: dataclasses.Field) -> Optional[type]:
    """Scalar type of a dataclass field, robust to string annotations."""
    t = str(f.type).replace("typing.", "")
    if t in ("int", "Optional[int]"):
        return int
    if t in ("float", "Optional[float]"):
        return float
    if t == "bool":
        return bool
    return None


def _resolve_aliases(cls: type, d: Dict[str, Any], path: str) -> Dict[str, Any]:
    """``d`` with each alias of ``cls`` renamed to its field; raises if an
    alias and its field are both given with values that differ."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for alias, name in _ALIASES.get(cls, {}).items():
        if alias not in d:
            continue
        value = d.pop(alias)
        hint = _field_hint(fields[name])
        if name in d and _coerce(hint, d[name]) != _coerce(hint, value):
            raise ValueError(
                f"{path}.{alias} ({value!r}) is the reference's name of "
                f"{path}.{name} ({d[name]!r}), and the two disagree")
        d[name] = value
    return d


def _dataclass_from_dict(cls: type, d: Mapping[str, Any], path: str) -> Any:
    d = _resolve_aliases(cls, dict(d), path)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - set(fields))
    if unknown:
        raise ValueError(
            f"unknown {path} config keys {unknown}; "
            f"expected a subset of {sorted(fields)}")
    kwargs: Dict[str, Any] = {}
    for name, value in d.items():
        f = fields[name]
        # the solver's "budget" is a nested SolveBudget dataclass; the
        # probe's "budget" is a plain float (sparse probe fraction)
        if name == "budget" and cls is SolverConfig:
            kwargs[name] = value if isinstance(value, SolveBudget) else \
                _dataclass_from_dict(SolveBudget, dict(value), f"{path}.{name}")
            continue
        kwargs[name] = _coerce(_field_hint(f), value)
        if name in ("chunk_candidates", "bucket_candidates") \
                and kwargs[name] is not None:
            kwargs[name] = _parse_dims(kwargs[name])
    return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """The one declaration a :class:`repro_torch.session.Session` needs.

    Everything defaults to a CPU-runnable synthetic setup; a production
    launch overrides the fabric, the mesh shape and the cache directory —
    nothing else has to change.
    """

    fabric: FabricConfig = dataclasses.field(default_factory=FabricConfig)
    probe: ProbeConfig = dataclasses.field(default_factory=ProbeConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    drift: DriftConfig = dataclasses.field(default_factory=DriftConfig)
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    overlap: OverlapConfig = dataclasses.field(default_factory=OverlapConfig)
    #: dominant collective payload of the workload (bytes)
    payload_bytes: float = 4e6
    #: workload shape for the default job mix ("train" | "serve")
    workload: str = "train"
    #: MoE workload: adds the EP all-to-all to the default mix
    moe: bool = False
    name: str = "session"

    def __post_init__(self):
        if self.workload not in ("train", "serve"):
            raise ValueError(
                f"SessionConfig.workload must be 'train' or 'serve'; "
                f"got {self.workload!r}")

    # -- dict / JSON round-trip -------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "SessionConfig":
        d = dict(d)
        kwargs: Dict[str, Any] = {}
        for section, cls in _SECTIONS.items():
            if section in d:
                value = d.pop(section)
                kwargs[section] = value if isinstance(value, cls) else \
                    _dataclass_from_dict(cls, dict(value), section)
        scalars = {"payload_bytes", "workload", "moe", "name"}
        unknown = sorted(set(d) - scalars)
        if unknown:
            raise ValueError(
                f"unknown session config keys {unknown}; expected sections "
                f"{sorted(_SECTIONS)} or scalars {sorted(scalars)}")
        if "payload_bytes" in d:
            kwargs["payload_bytes"] = float(d["payload_bytes"])
        if "moe" in d:
            kwargs["moe"] = _coerce(bool, d["moe"])
        for k in ("workload", "name"):
            if k in d:
                kwargs[k] = str(d[k])
        return SessionConfig(**kwargs)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_json(s: str) -> "SessionConfig":
        return SessionConfig.from_dict(json.loads(s))

    @staticmethod
    def load(path: str) -> "SessionConfig":
        with open(path) as f:
            return SessionConfig.from_json(f.read())

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    # -- overrides ---------------------------------------------------------
    def replace(self, **updates: Any) -> "SessionConfig":
        """Functional update; section values may be partial dicts.

        Merging is deep: ``replace(solver={"budget": {"iters": 200}})``
        keeps every other budget field of the current config.
        """
        def deep_merge(dst: Dict[str, Any], src: Mapping[str, Any]) -> None:
            for k, v in src.items():
                if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
                    deep_merge(dst[k], v)
                else:
                    dst[k] = v

        merged = self.to_dict()
        for key, value in updates.items():
            if key in _SECTIONS and isinstance(value, Mapping):
                deep_merge(merged[key], value)
            elif key in _SECTIONS and dataclasses.is_dataclass(value):
                merged[key] = dataclasses.asdict(value)
            else:
                merged[key] = value
        return SessionConfig.from_dict(merged)

    # -- environment -------------------------------------------------------
    @staticmethod
    def from_env(prefix: str = "REPRO_",
                 base: Optional["SessionConfig"] = None,
                 environ: Optional[Mapping[str, str]] = None) -> "SessionConfig":
        """Overlay ``REPRO_<SECTION>_<FIELD>`` variables onto ``base``.

        ``REPRO_FABRIC_KIND=tpu-fleet``, ``REPRO_CACHE_DIR=.plan_cache``,
        ``REPRO_MESH_SHAPE=8x8``, ``REPRO_PAYLOAD_BYTES=4e6`` — the CLI
        and launchers all honor the same variables.
        """
        env = dict(os.environ if environ is None else environ)
        cfg = base if base is not None else SessionConfig()
        merged = cfg.to_dict()
        scalars = {"payload_bytes", "workload", "moe", "name"}
        overlay: Dict[str, Dict[str, Any]] = {}
        for key, value in sorted(env.items()):
            if not key.startswith(prefix):
                continue
            rest = key[len(prefix):].lower()
            head, _, tail = rest.partition("_")
            if head in _SECTIONS and tail:
                if head == "solver" and tail.startswith("budget_"):
                    merged["solver"].setdefault("budget", {})
                    merged["solver"]["budget"][tail[len("budget_"):]] = value
                else:
                    overlay.setdefault(head, {})[tail] = value
            elif rest in scalars:
                merged[rest] = value
            else:
                raise ValueError(
                    f"unrecognized environment override {key}: no section "
                    f"or scalar named {rest!r}")
        for head, values in overlay.items():
            # an alias overrides the base's field, as its field would
            merged[head].update(_resolve_aliases(_SECTIONS[head], values, head))
        return SessionConfig.from_dict(merged)
