"""The port's Session, its config, plan cache, drift monitor, faults and
sparse probe against the JAX package's (numpy) originals on the same inputs."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import repro.fabric as ref_fabric  # noqa: E402
import repro.faults as ref_faults  # noqa: E402
import repro.session as ref_session  # noqa: E402
import repro_torch.fabric as fabric  # noqa: E402
import repro_torch.faults as faults  # noqa: E402
from repro.core.dynamic import bottleneck_swap as ref_bottleneck_swap  # noqa: E402
from repro.core.cost_models import make_cost_model as ref_make_cost_model  # noqa: E402
from repro_torch.core import bottleneck_swap, make_cost_model  # noqa: E402
from repro_torch.launch import PlannedMesh  # noqa: E402
from repro_torch.session import (  # noqa: E402
    EVENTS,
    Session,
    SessionConfig,
    SessionError,
)

N = 8
# a small, fast config: a scrambled 8-node Clos datacenter, an 8-rank mesh
CFG = {
    "fabric": {"kind": "datacenter", "nodes": N, "scramble_seed": 1},
    "probe": {"n_probes": 64},
    "solver": {"budget": {"iters": 300, "chains": 2}},
    "mesh": {"shape": [N], "axis_names": ["data"]},
    "payload_bytes": 988_065_536.0,
}


def _sessions(extra=None):
    d = dict(CFG, **(extra or {}))
    return Session(SessionConfig.from_dict(d)), \
        ref_session.Session(ref_session.SessionConfig.from_dict(d))


def _entries(plan):
    return {k: (e.algo, dict(e.algo_kwargs), e.chunks, tuple(e.perm),
                e.bucket_bytes, e.expected_time, e.group)
            for k, e in plan.entries.items()}


def _assert_same_plan(a, b):
    assert a.fingerprint.digest == b.fingerprint.digest
    assert _entries(a) == _entries(b)
    if b.mesh_plan is None:
        assert a.mesh_plan is None
    else:
        np.testing.assert_array_equal(a.mesh_plan.flat, b.mesh_plan.flat)


# -- config ------------------------------------------------------------------

def test_config_round_trips(tmp_path):
    cfg = SessionConfig.from_dict(CFG).replace(
        drift={"threshold": 1.3}, solver={"budget": {"iters": 200}},
        overlap={"mode": "fused", "use_kernel_add": False})
    assert cfg.solver.budget.iters == 200 and cfg.solver.budget.chains == 2
    assert SessionConfig.from_dict(cfg.to_dict()) == cfg
    assert SessionConfig.from_json(cfg.to_json()) == cfg
    path = str(tmp_path / "session.json")
    cfg.dump(path)
    assert SessionConfig.load(path) == cfg
    env = {"REPRO_FABRIC_NODES": "16", "REPRO_MESH_SHAPE": "4x4",
           "REPRO_MESH_AXIS_NAMES": "data,model",
           "REPRO_SOLVER_BUDGET_ITERS": "50", "REPRO_PAYLOAD_BYTES": "4e6",
           "REPRO_OVERLAP_MODE": "sequential"}
    got = SessionConfig.from_env(base=cfg, environ=env)
    assert (got.fabric.nodes, got.mesh.shape, got.solver.budget.iters,
            got.payload_bytes, got.overlap.mode) == \
        (16, (4, 4), 50, 4e6, "sequential")
    for bad in ({"fabric": {"nodez": 3}}, {"wat": 1},
                {"overlap": {"mode": "eager"}}):
        with pytest.raises(ValueError):
            SessionConfig.from_dict(dict(CFG, **bad))
    with pytest.raises(ValueError, match="unrecognized environment"):
        SessionConfig.from_env(environ={"REPRO_NOPE": "1"})


def test_config_sections_equal_the_reference():
    """Every section but ``overlap`` (the port's kernel switch) resolves
    the same dict as the reference's."""
    a = SessionConfig.from_dict(CFG).to_dict()
    b = ref_session.SessionConfig.from_dict(CFG).to_dict()
    assert set(a) == set(b)
    for key in a:
        if key != "overlap":
            assert a[key] == b[key], key
    assert a["overlap"]["use_kernel_add"] is True
    assert {k: v for k, v in a["overlap"].items() if k != "use_kernel_add"} == \
        {k: v for k, v in b["overlap"].items() if k != "use_pallas_add"}


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (2, 0, 3, 1)])
def test_planned_mesh_places_shard_i_on_rank_order_i(order):
    """Mesh slot i (rows 2i, 2i+1 of a batch of 8) goes to rank order[i]."""
    mesh = PlannedMesh(order=order, shape=(4,), axis_names=("data",),
                       device=torch.device("cpu"))
    rows = mesh.batch_rows(8).reshape(4, 2)
    for slot, rank in enumerate(order):
        assert rows[rank].tolist() == [2 * slot, 2 * slot + 1]
    with pytest.raises(ValueError, match="does not split"):
        mesh.batch_rows(6)


# -- lifecycle ---------------------------------------------------------------

def test_lifecycle_hooks_and_plan_equal_the_reference():
    s, ref = _sessions()
    seen = []
    for ev in EVENTS:
        s.on(ev, lambda sess, _ev=ev, **info: seen.append(_ev))
    with pytest.raises(ValueError, match="unknown session event"):
        s.on("nope", print)
    assert s.state == "created"
    plan, ref_plan = s.plan(), ref.plan()
    assert s.state == "planned" and seen == ["attach", "plan"]
    _assert_same_plan(plan, ref_plan)
    assert s.hints() == ref.hints()
    applied = s.apply(device="cpu")
    assert s.state == "applied" and seen[-1] == "apply"
    assert isinstance(applied.mesh, PlannedMesh)
    assert applied.mesh.order == tuple(int(i) for i in ref_plan.mesh_plan.flat)
    assert applied.mesh.device.type == "cpu" and applied.mesh.size == N
    assert "plan " + plan.fingerprint.digest in applied.summary()
    # the reducer runs the plan's certified schedule, as the reference's
    # lowering orders it (bcube ends reduce-scattered: a ring at its order)
    ref_sched = ref.lower("all-reduce", 4 * 1024 * 1024).schedule
    red = s.overlap_step(mode="bucketed", transport="runner")
    assert red.n == N and red.schedule.algorithm == "ring"
    assert red.schedule.order == tuple(ref_sched.order)
    assert red.bucket_bytes == ref_plan.lookup("all-reduce", 988_065_536.0).bucket_bytes
    # a second plan on the same fabric is a cache hit
    s.plan()
    assert s.service.stats["cache_hits"] == 1
    s.close()
    ref.close()
    assert s.state == "closed" and seen[-1] == "close"
    with pytest.raises(SessionError, match="closed"):
        s.plan()
    s.close()                                        # idempotent


def test_live_fabric_raises_naming_the_device_probe():
    with Session(fabric={"kind": "live"}) as s:
        with pytest.raises(SessionError, match="item 13"):
            s.attach()


# -- drift, monitor, elastic membership ------------------------------------

def test_drift_replans_as_the_reference():
    s, ref = _sessions()
    with s, ref:
        s.plan()
        ref.plan()
        replans = []
        s.on("replan", lambda sess, **info: replans.append(info["plan"]))
        c = s.reference_matrix().copy()
        np.testing.assert_array_equal(c, ref.reference_matrix())
        # a congested node: every link of node 3 ten times slower
        c[3, :] *= 10.0
        c[:, 3] *= 10.0
        a, b = s.observe(c), ref.observe(c)
        assert (a.stale, a.degraded, a.repaired, a.invalidated) == \
            (b.stale, b.degraded, b.repaired, b.invalidated)
        assert a.stale and len(replans) == 1
        _assert_same_plan(s.planned, ref.planned)


def test_node_leave_and_join_recover_as_the_reference():
    s, ref = _sessions()
    with s, ref:
        s.plan()
        ref.plan()
        a, b = s.on_node_leave([2, 5]), ref.on_node_leave([2, 5])
        assert s.alive == ref.alive == [0, 1, 3, 4, 6, 7]
        _assert_same_plan(a, b)
        assert a.meta["rungs"] == b.meta["rungs"]
        assert s.events[-1][1]["rungs"] == ref.events[-1][1]["rungs"]
        a, b = s.on_node_join([5]), ref.on_node_join([5])
        assert s.alive == ref.alive == [0, 1, 3, 4, 5, 6, 7]
        _assert_same_plan(a, b)
        with pytest.raises(ValueError):
            s.on_node_leave([99])


def test_monitor_degrades_then_halts_to_identity():
    s = Session(SessionConfig.from_dict(CFG).replace(
        retry={"failure_threshold": 2, "halt_threshold": 3,
               "base_delay_s": 0.0, "max_delay_s": 0.0}))
    states = []
    s.on("degraded", lambda sess, **info: states.append(info["state"]))
    with s:
        s.plan()

        def poll():
            raise RuntimeError("probe timed out")

        thread = s.monitor(poll=poll, interval_s=0.001)
        thread.join(timeout=10)
        assert not thread.is_alive()
        assert s.health == "halted" and states == ["degraded", "halted"]
        assert all(e.perm == tuple(e.group) for e in s.planned.entries.values())
        assert s.planned.meta["fallback"] == "identity"


# -- the copied numpy layers ---------------------------------------------------

@pytest.mark.parametrize("budget", [0.25, 0.5])
def test_sparse_probe_equals_the_reference(budget):
    fab, _ = fabric.scramble(fabric.make_datacenter(32, seed=0), seed=1)
    rfab, _ = ref_fabric.scramble(ref_fabric.make_datacenter(32, seed=0), seed=1)
    a = fabric.sparse_probe_fabric(fab, budget=budget, n_probes=16, seed=0)
    b = ref_fabric.sparse_probe_fabric(rfab, budget=budget, n_probes=16, seed=0)
    np.testing.assert_array_equal(a.lat, b.lat)
    np.testing.assert_array_equal(a.bw, b.bw)
    assert a.probes_used == b.probes_used
    assert a.hierarchy.to_dict() == b.hierarchy.to_dict()
    ra, moved_a = fabric.refresh_sparse(fab, a, seed=3)
    rb, moved_b = ref_fabric.refresh_sparse(rfab, b, seed=3)
    assert moved_a == moved_b
    np.testing.assert_array_equal(ra.lat, rb.lat)


def test_sparse_session_plan_equals_the_reference():
    extra = {"fabric": {"kind": "datacenter", "nodes": 16, "scramble_seed": 1},
             "probe": {"n_probes": 16, "mode": "sparse", "budget": 0.3},
             "mesh": {"shape": [16], "axis_names": ["data"]}}
    s, ref = _sessions(extra)
    with s, ref:
        _assert_same_plan(s.plan(), ref.plan())
        assert s.hierarchy.to_dict() == ref.hierarchy.to_dict()


def test_retry_health_and_swap_equal_the_reference():
    pol = faults.RetryPolicy(max_retries=4, jitter=0.2, seed=7)
    rpol = ref_faults.RetryPolicy(max_retries=4, jitter=0.2, seed=7)
    assert [pol.delay(i) for i in range(6)] == [rpol.delay(i) for i in range(6)]
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert faults.call_with_retries(flaky, pol, sleep=sleeps.append) == "ok"
    assert len(sleeps) == 2
    with pytest.raises(faults.RetryError):
        faults.call_with_retries(lambda: 1 / 0, dataclasses.replace(
            pol, max_retries=1), sleep=lambda d: None)
    h = faults.HealthTracker(failure_threshold=2, halt_threshold=3)
    assert [h.record_failure("x") for _ in range(3)] == [None, "degraded", "halted"]
    assert h.record_success() is None and h.state == "halted"
    h.reset()
    assert h.state == "healthy"
    assert faults.restrict_perm([4, 0, 3, 1, 2], [0, 2, 4]) == \
        ref_faults.restrict_perm([4, 0, 3, 1, 2], [0, 2, 4]) == [4, 0, 2]
    c = np.random.default_rng(0).uniform(1e-6, 1e-4, (N, N))
    c = c + c.T
    np.fill_diagonal(c, 0.0)
    perm = np.random.default_rng(1).permutation(N)
    a = bottleneck_swap(make_cost_model("ring", c, 0.0), perm)
    b = ref_bottleneck_swap(ref_make_cost_model("ring", c, 0.0), perm)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]
    assert json.loads(json.dumps(SessionConfig().to_dict()))["retry"]["seed"] == 0


# -- the reference's configuration and plan store ------------------------------

def test_reference_config_loads_with_its_spelling_of_the_kernel_add(tmp_path):
    """A config the reference dumps (``use_pallas_add`` and all) loads, and
    every field resolves as the reference's does."""
    ref_cfg = ref_session.SessionConfig.from_dict(CFG).replace(
        overlap={"mode": "fused", "use_pallas_add": True})
    path = str(tmp_path / "ref.json")
    ref_cfg.dump(path)
    for got in (SessionConfig.from_dict(ref_cfg.to_dict()),
                SessionConfig.load(path)):
        a, b = got.to_dict(), ref_cfg.to_dict()
        assert a["overlap"].pop("use_kernel_add") is b["overlap"].pop(
            "use_pallas_add") is True
        assert a == b
    default = SessionConfig.from_dict(ref_session.SessionConfig().to_dict())
    assert default.overlap.use_kernel_add is False   # the reference's default
    with pytest.raises(ValueError, match="disagree"):
        SessionConfig.from_dict(
            {"overlap": {"use_pallas_add": True, "use_kernel_add": False}})
    both = SessionConfig.from_dict(
        {"overlap": {"use_pallas_add": "1", "use_kernel_add": True}})
    assert both.overlap.use_kernel_add is True


@pytest.mark.parametrize("value,want", [("1", True), ("0", False)])
def test_environment_reads_the_reference_spelling(value, want):
    """``REPRO_OVERLAP_USE_PALLAS_ADD`` overrides the base, as the
    reference reads it; with ``..._USE_KERNEL_ADD`` beside it they must agree."""
    env = {"REPRO_OVERLAP_USE_PALLAS_ADD": value}
    base = SessionConfig().replace(overlap={"use_kernel_add": not want})
    assert SessionConfig.from_env(base=base, environ=env).overlap.use_kernel_add \
        is want
    assert ref_session.SessionConfig.from_env(environ=env).overlap.use_pallas_add \
        is want
    env["REPRO_OVERLAP_USE_KERNEL_ADD"] = value
    assert SessionConfig.from_env(environ=env).overlap.use_kernel_add is want
    env["REPRO_OVERLAP_USE_KERNEL_ADD"] = "0" if want else "1"
    with pytest.raises(ValueError, match="disagree"):
        SessionConfig.from_env(environ=env)


def test_plan_store_on_disk_hits_and_invalidates_as_the_reference(tmp_path):
    """One sequence on a ``cache.dir`` of each side's own: compile and
    store, a fresh session's disk hit, its memory hit, invalidation of the
    fabric, a miss and a recompile.  The stats, the files and the plans
    equal the reference's at every step."""
    sides = {}
    for name, mod in (("port", None), ("ref", ref_session)):
        store = tmp_path / name
        cfg = dict(CFG, cache={"dir": str(store)})
        make = (lambda c=cfg: Session(SessionConfig.from_dict(c))) if mod is None \
            else (lambda c=cfg: mod.Session(mod.SessionConfig.from_dict(c)))
        trail = []
        with make() as s:
            plan = s.plan()
            trail.append((dict(s.cache.stats), dict(s.service.stats)))
        with make() as s:
            again = s.plan()                       # from the store
            s.plan()                               # from memory
            trail.append((dict(s.cache.stats), dict(s.service.stats)))
            files = sorted(p.name for p in store.iterdir())
            dropped = s.cache.invalidate(again.fingerprint)
            trail.append((dropped, sorted(p.name for p in store.iterdir())))
        with make() as s:
            third = s.plan()                       # gone: compiled anew
            trail.append((dict(s.cache.stats), dict(s.service.stats)))
        sides[name] = (trail, files, [plan, again, third])
    (trail, files, plans), (ref_trail, ref_files, ref_plans) = \
        sides["port"], sides["ref"]
    assert trail == ref_trail
    assert files == ref_files and len(files) == 1
    assert trail[1][0]["disk_hits"] == 1 and trail[1][0]["hits"] == 1
    assert trail[2] == (2, []) and trail[3][1]["compiles"] == 1
    for got, want in zip(plans, ref_plans):
        _assert_same_plan(got, want)


# -- wrap(): the non-intrusive patch (tests/test_session.py:239-292) -------

# the reference test's small config
WRAP_CFG = {
    "fabric": {"kind": "datacenter", "nodes": 12, "scramble_seed": 1},
    "solver": {"budget": {"iters": 80, "chains": 2}},
    "payload_bytes": 1e6,
}


def _wrap_config(**over):
    return SessionConfig.from_dict(WRAP_CFG).replace(**over)


def test_wrap_patches_and_restores_launch_surface():
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import moe_a2a

    orig_make = mesh_mod.make_production_mesh
    orig_arm = moe_a2a.arm_ep
    s = Session(_wrap_config())
    with s.wrap():
        assert s.wrapped
        assert mesh_mod.make_production_mesh is not orig_make
        assert moe_a2a.arm_ep is not orig_arm
    assert not s.wrapped
    assert mesh_mod.make_production_mesh is orig_make
    assert moe_a2a.arm_ep is orig_arm
    with pytest.raises(SessionError, match="closed"):
        s.close() or s.wrap()


def test_wrap_injects_plan_into_arm_ep():
    """An unmodified ``arm_ep`` call site (no ``plan``) arms the session's
    solved all-to-all ring, as the reference's; a ``plan=`` or ``session=``
    the caller passes wins."""
    from repro_torch.launch import make_mesh
    from repro_torch.parallel import moe_a2a

    with Session(_wrap_config(moe=True)) as s:
        s.plan()
        entry = s.planned.lookup("all-to-all", 1.0)
        assert entry is not None
        mesh = make_mesh((12,), ("data",), device="cpu")
        with s.wrap():
            moe_a2a.arm_ep(mesh, "data", None)   # unmodified call site
            armed = moe_a2a._EP_STATE["a2a_order"]
            moe_a2a.arm_ep(mesh, "data", None, session=s)
            assert moe_a2a._EP_STATE["a2a_order"] == armed
        moe_a2a.arm_ep(mesh, "data", None)       # unwrapped: no plan
        assert moe_a2a._EP_STATE["a2a_order"] is None
        moe_a2a.clear_ep()
    assert armed == tuple(int(i) for i in entry.local_perm)


def test_wrap_twice_raises():
    with Session(_wrap_config()) as s:
        guard = s.wrap()
        try:
            with pytest.raises(SessionError, match="already wrapped"):
                s.wrap()
        finally:
            guard.__exit__(None, None, None)


def test_close_unwraps():
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import moe_a2a

    orig_arm = moe_a2a.arm_ep
    orig_make = mesh_mod.make_production_mesh
    s = Session(_wrap_config())
    s.wrap()
    assert moe_a2a.arm_ep is not orig_arm
    s.close()
    assert moe_a2a.arm_ep is orig_arm
    assert mesh_mod.make_production_mesh is orig_make


def test_wrapped_production_mesh_is_the_plans_order():
    """A plan compiled at the production shape ``(16, 16)`` on the
    simulated fleet: inside ``wrap``, ``make_production_mesh()`` is the
    plan's order (the reference's ``devices[plan.flat]``); outside it, and
    for the multi-pod shape the plan does not have, the identity."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.plan import CollectiveRequest, JobMix

    cfg = SessionConfig.from_dict({
        "fabric": {"kind": "tpu-fleet", "n_pods": 1, "pod_shape": [16, 16],
                   "scramble_seed": 0},
        "mesh": {"shape": [16, 16], "axis_names": ["data", "model"]},
        "probe": {"n_probes": 4},
        "solver": {"budget": {"iters": 20, "chains": 1}},
        "payload_bytes": 1e6})
    with Session(cfg) as s:
        # one small request: the mesh assignment is what this case reads
        plan = s.plan(mix=JobMix((CollectiveRequest("all-reduce", 1e6,
                                                    group=(0, 1)),)))
        want = tuple(int(i) for i in plan.mesh_plan.flat)
        assert want != tuple(range(256))
        with s.wrap():
            mesh = mesh_mod.make_production_mesh(device="cpu")
            pods = mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
        assert (mesh.order, mesh.shape, mesh.axis_names) == \
            (want, (16, 16), ("data", "model"))
        assert pods.order == tuple(range(512)) and pods.shape == (2, 16, 16)
        assert mesh_mod.make_production_mesh(device="cpu").order == \
            tuple(range(256))
