"""The port's planner copies against the reference on the same numpy inputs.

Fabrics, probes, hierarchy inference, cost models, solvers, mesh
reordering, the pricing executors, the static verifier, the plan compiler
and the schedule ``reducer_from_plan`` certifies: every array and plan
equal exactly, on the CPU at n <= 16.
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import repro.analysis as R_an  # noqa: E402
import repro.collective as R_coll  # noqa: E402
import repro.core.cost_models as R_cm  # noqa: E402
import repro.core.reorder as R_re  # noqa: E402
import repro.core.solver as R_so  # noqa: E402
import repro.fabric as R_fab  # noqa: E402
import repro.plan as R_plan  # noqa: E402
from repro.session.mixes import serve_mix as R_serve_mix  # noqa: E402
from repro.session.mixes import train_mix as R_train_mix  # noqa: E402
from repro.train.overlap_grads import certified_allreduce as R_certified  # noqa: E402

import repro_torch.analysis as T_an  # noqa: E402
import repro_torch.collective as T_coll  # noqa: E402
import repro_torch.core.cost_models as T_cm  # noqa: E402
import repro_torch.core.reorder as T_re  # noqa: E402
import repro_torch.core.solver as T_so  # noqa: E402
import repro_torch.fabric as T_fab  # noqa: E402
import repro_torch.plan as T_plan  # noqa: E402
from repro_torch.session import serve_mix as T_serve_mix  # noqa: E402
from repro_torch.session import train_mix as T_train_mix  # noqa: E402
from repro_torch.train import reducer_from_plan  # noqa: E402

#: the configuration chip_smoke.py plans qwen2-0.5b's all-reduce on
SMOKE_PAYLOAD = 988_065_536


def _fabric(F, kind, n, seed):
    if kind == "datacenter":
        return F.make_datacenter(n, nodes_per_rack=4, racks_per_agg=2, seed=seed)
    return F.make_tpu_fleet(n_pods=2, pod_shape=(2, n // 4), seed=seed)


def _same_fabric(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.lat, b.lat)
    np.testing.assert_array_equal(a.bw, b.bw)
    np.testing.assert_array_equal(a.link_bw, b.link_bw)
    assert [list(map(tuple, row)) for row in a.paths] == \
        [list(map(tuple, row)) for row in b.paths]
    assert a.meta == b.meta


@pytest.mark.parametrize("kind", ["datacenter", "tpu_fleet"])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("seed", [0, 3])
def test_fabric_probe_and_hierarchy_equal_the_reference(kind, n, seed):
    ra, ta = _fabric(R_fab, kind, n, seed), _fabric(T_fab, kind, n, seed)
    _same_fabric(ra, ta)
    (rs, rh), (ts, th) = R_fab.scramble(ra, seed=seed + 1), \
        T_fab.scramble(ta, seed=seed + 1)
    np.testing.assert_array_equal(rh, th)
    _same_fabric(rs, ts)
    np.testing.assert_array_equal(ra.cost_matrix(1e6), ta.cost_matrix(1e6))
    rp, tp = R_fab.probe_fabric(rs, seed=seed), T_fab.probe_fabric(ts, seed=seed)
    np.testing.assert_array_equal(rp.lat, tp.lat)
    np.testing.assert_array_equal(rp.bw, tp.bw)
    for size in (0.0, 4e6):
        np.testing.assert_array_equal(R_fab.cost_matrix(rp, size),
                                      T_fab.cost_matrix(tp, size))
    c = R_fab.cost_matrix(rp, 4e6)
    assert R_fab.infer_hierarchy(c).to_dict() == \
        T_fab.infer_hierarchy(c).to_dict()
    fp_r = R_plan.fabric_fingerprint(rp.lat, rp.bw)
    fp_t = T_plan.fabric_fingerprint(tp.lat, tp.bw)
    assert fp_r.to_dict() == fp_t.to_dict()


def _cost_inputs(n, seed):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(1e-6, 1e-4, (n, n))
    lat = np.maximum(lat, lat.T)
    np.fill_diagonal(lat, 0.0)
    bw = rng.uniform(1e9, 1e10, (n, n))
    bw = np.minimum(bw, bw.T)
    perms = np.stack([rng.permutation(n) for _ in range(6)])
    return lat, bw, perms


@pytest.mark.parametrize("algo", sorted(R_cm.COST_MODELS))
@pytest.mark.parametrize("mode", ["matrix", "lat_bw"])
def test_cost_models_equal_the_reference(algo, mode):
    n = 16
    lat, bw, perms = _cost_inputs(n, seed=7)
    kw = {"base": 2} if algo == "bcube" else {}
    if mode == "matrix":
        args = dict(cost_matrix=lat, size_bytes=4e6, **kw)
    else:
        args = dict(size_bytes=4e6, lat=lat, bw=bw, **kw)
    rm, tm = R_cm.make_cost_model(algo, **args), T_cm.make_cost_model(algo, **args)
    for p in perms:
        assert rm.cost(p) == tm.cost(p)
    np.testing.assert_array_equal(rm.cost_batch(perms), tm.cost_batch(perms))


@pytest.mark.parametrize("engine", ["vectorized", "reference"])
@pytest.mark.parametrize("algo", ["ring", "halving_doubling"])
def test_solvers_equal_the_reference(engine, algo):
    n = 16
    lat, bw, _ = _cost_inputs(n, seed=2)
    args = dict(size_bytes=1e6, lat=lat, bw=bw)
    rm, tm = R_cm.make_cost_model(algo, **args), T_cm.make_cost_model(algo, **args)
    for kw in (dict(method="auto"), dict(method="sa")):
        r = R_so.solve(rm, iters=120, chains=4, seed=1, engine=engine, **kw)
        t = T_so.solve(tm, iters=120, chains=4, seed=1, engine=engine, **kw)
        np.testing.assert_array_equal(r.perm, t.perm)
        assert r.cost == t.cost
    r = R_so.solve_worst(rm, iters=120, chains=4, seed=1, engine=engine)
    t = T_so.solve_worst(tm, iters=120, chains=4, seed=1, engine=engine)
    np.testing.assert_array_equal(r.perm, t.perm)
    assert r.cost == t.cost


def test_local_search_and_small_solves_equal_the_reference():
    n = 16
    lat, _, perms = _cost_inputs(n, seed=5)
    start = perms[0]
    np.testing.assert_array_equal(R_so.two_opt(lat, start), T_so.two_opt(lat, start))
    np.testing.assert_array_equal(R_so.or_opt(lat, start), T_so.or_opt(lat, start))
    rm = R_cm.make_cost_model("halving_doubling", cost_matrix=lat, size_bytes=1e6)
    tm = T_cm.make_cost_model("halving_doubling", cost_matrix=lat, size_bytes=1e6)
    np.testing.assert_array_equal(R_so.swap_hill_climb(rm, start),
                                  T_so.swap_hill_climb(tm, start))
    # n <= 8: exhaustive search inside solve(method="auto")
    sub = lat[:8, :8]
    r = R_so.solve(R_cm.make_cost_model("ring", cost_matrix=sub, size_bytes=1e6))
    t = T_so.solve(T_cm.make_cost_model("ring", cost_matrix=sub, size_bytes=1e6))
    np.testing.assert_array_equal(r.perm, t.perm)
    assert r.cost == t.cost


@pytest.mark.parametrize("shape,names", [((16,), ("data",)),
                                         ((4, 4), ("data", "model"))])
def test_mesh_assignment_and_hierarchical_perm_equal_the_reference(shape, names):
    fab, _ = R_fab.scramble(R_fab.make_datacenter(16, nodes_per_rack=4,
                                                  racks_per_agg=2, seed=1), seed=2)
    c = R_fab.cost_matrix(R_fab.probe_fabric(fab, seed=0), 1e6)
    c = np.maximum(c, c.T)
    r = R_re.optimize_mesh_assignment(c, shape, names, seed=0)
    t = T_re.optimize_mesh_assignment(c, shape, names, seed=0)
    np.testing.assert_array_equal(r.assignment, t.assignment)
    assert (r.cost, r.baseline_cost, r.per_axis) == (t.cost, t.baseline_cost, t.per_axis)
    h_r, h_t = R_fab.infer_hierarchy(c), T_fab.infer_hierarchy(c)
    assert not h_r.flat
    np.testing.assert_array_equal(R_re.hierarchical_perm(c, h_r, seed=0),
                                  T_re.hierarchical_perm(c, h_t, seed=0))
    rh = R_re.optimize_mesh_assignment(c, shape, names, seed=0, hierarchy=h_r)
    th = T_re.optimize_mesh_assignment(c, shape, names, seed=0, hierarchy=h_t)
    np.testing.assert_array_equal(rh.assignment, th.assignment)
    assert R_re.mesh_axis_cost(r.assignment, c, 0) == \
        T_re.mesh_axis_cost(t.assignment, c, 0)


def _programs(C, n, size=1 << 20):
    out = []
    for name in C.registered_builders():
        b = C.get_builder(name)
        if not b.feasible(n):
            continue
        for kind in b.kinds:
            for kw in b.candidate_kwargs(n) or [{}]:
                op = C.CollectiveOp(kind, float(size), tuple(range(n)))
                out.append((name, kind, kw, C.compile_op(op, name, **kw)))
    return out


def test_executor_estimates_equal_the_reference():
    n = 8
    fab, _ = R_fab.scramble(R_fab.make_datacenter(n, nodes_per_rack=4,
                                                  racks_per_agg=2, seed=0), seed=1)
    tfab, _ = T_fab.scramble(T_fab.make_datacenter(n, nodes_per_rack=4,
                                                   racks_per_agg=2, seed=0), seed=1)
    perm = [0, 7, 3, 5, 2, 4, 1, 6]
    rp, tp = _programs(R_coll, n), _programs(T_coll, n)
    assert [p[:3] for p in rp] == [p[:3] for p in tp]
    assert len({p[0] for p in rp}) == len(R_coll.registered_builders())
    r_exec = [R_coll.SimExecutor(fab), R_coll.AnalyticExecutor(lat=fab.lat, bw=fab.bw),
              R_coll.AnalyticExecutor(cost_matrix=fab.cost_matrix(1e6))]
    t_exec = [T_coll.SimExecutor(tfab), T_coll.AnalyticExecutor(lat=tfab.lat, bw=tfab.bw),
              T_coll.AnalyticExecutor(cost_matrix=tfab.cost_matrix(1e6))]
    for (_, _, _, rprog), (_, _, _, tprog) in zip(rp, tp):
        rprog = R_coll.chunk(R_coll.apply_permutation(rprog, perm), 2)
        tprog = T_coll.chunk(T_coll.apply_permutation(tprog, perm), 2)
        assert rprog.fingerprint() == tprog.fingerprint()
        for re_, te_ in zip(r_exec, t_exec):
            assert re_.estimate(rprog) == te_.estimate(tprog)


def test_verify_program_finding_codes_equal_the_reference():
    n = 8
    fab = R_fab.make_datacenter(n, nodes_per_rack=4, racks_per_agg=2, seed=0)
    tfab = T_fab.make_datacenter(n, nodes_per_rack=4, racks_per_agg=2, seed=0)
    h = R_fab.infer_hierarchy(fab.cost_matrix(1e6))
    th = T_fab.infer_hierarchy(tfab.cost_matrix(1e6))
    assert tuple(R_an.PASSES) == tuple(T_an.PASSES)
    assert R_an.GATE_PASSES == T_an.GATE_PASSES
    for (_, _, _, rprog), (_, _, _, tprog) in zip(_programs(R_coll, n),
                                                  _programs(T_coll, n)):
        for ctx_r, ctx_t in ((dict(fabric=fab), dict(fabric=tfab)),
                             (dict(hierarchy=h), dict(hierarchy=th)),
                             ({}, {})):
            rr = R_an.verify_program(rprog, **ctx_r)
            tr = T_an.verify_program(tprog, **ctx_t)
            assert [(f.pass_name, f.code, f.severity) for f in rr.findings] == \
                [(f.pass_name, f.code, f.severity) for f in tr.findings]
            assert rr.ok == tr.ok and rr.passes_run == tr.passes_run
        R_an.require_valid(rprog, passes=R_an.GATE_PASSES)
        T_an.require_valid(tprog, passes=T_an.GATE_PASSES)


def _smoke_plan(F, P, mix):
    fab, _ = F.scramble(F.make_datacenter(8, nodes_per_rack=4, racks_per_agg=2,
                                          seed=0), seed=1)
    plan = P.PlanCompiler(fabric=fab, seed=0).compile(
        F.probe_fabric(fab, seed=0), mix(SMOKE_PAYLOAD), mesh_shape=(8,))
    return plan


def _plan_dict(plan):
    d = json.loads(plan.to_json())
    d.pop("compile_seconds")
    return d


@pytest.fixture(scope="module")
def smoke_plans():
    return (_smoke_plan(R_fab, R_plan, R_train_mix),
            _smoke_plan(T_fab, T_plan, T_train_mix))


def test_compiled_plan_equals_the_reference(smoke_plans):
    r, t = smoke_plans
    assert _plan_dict(r) == _plan_dict(t)
    assert [e.program_fingerprint for e in r.entries.values()] == \
        [e.program_fingerprint for e in t.entries.values()]
    for e in t.entries.values():
        assert e.program().fingerprint() == e.program_fingerprint
    # the round trip through JSON keeps every entry and the mesh plan
    back = T_plan.Plan.from_json(t.to_json())
    assert _plan_dict(back) == _plan_dict(t)
    assert t.compile_seconds > 0.0


@pytest.mark.parametrize("mix", ["train", "serve"])
def test_analytic_oracle_plan_equals_the_reference(mix):
    """``fabric=None``: candidates scored by their cost models on a probe."""
    rmix = {"train": R_train_mix, "serve": R_serve_mix}[mix](64e6)
    tmix = {"train": T_train_mix, "serve": T_serve_mix}[mix](64e6)
    fab = R_fab.make_datacenter(16, nodes_per_rack=4, racks_per_agg=2, seed=4)
    probe = R_fab.probe_fabric(fab, seed=1)
    budget = dict(iters=60, chains=2)
    r = R_plan.PlanCompiler(budget=R_plan.SolveBudget(**budget), seed=0).compile(
        probe, rmix, mesh_shape=(4, 4), axis_names=("data", "model"))
    t = T_plan.PlanCompiler(budget=T_plan.SolveBudget(**budget), seed=0).compile(
        T_fab.ProbeResult(lat=probe.lat, bw=probe.bw, n_probes=probe.n_probes,
                          percentile=probe.percentile),
        tmix, mesh_shape=(4, 4), axis_names=("data", "model"))
    assert _plan_dict(r) == _plan_dict(t)
    assert r.meta["oracle"] == t.meta["oracle"] == "cost_model"
    assert [e.program_fingerprint for e in r.entries.values()] == \
        [e.program_fingerprint for e in t.entries.values()]


def test_reducer_from_plan_certifies_the_reference_schedule(smoke_plans):
    """The schedule the port's reducer runs is the one the reference's
    ``reducer_from_plan`` computes: the bucket octave's entry, lowered and
    certified, falling back to a ring at the planned order when the
    lowering does not end all-reduced (bcube)."""
    r_plan, t_plan = smoke_plans
    entry = r_plan.lookup("all-reduce", SMOKE_PAYLOAD)
    bb = float(entry.bucket_bytes or SMOKE_PAYLOAD)
    entry_b = r_plan.lookup("all-reduce", bb)
    prog = entry_b.program()
    sched = R_coll.JaxExecutor().lower_schedule(prog)
    R_an.require_certified(prog, sched)
    if sched.postcondition != "allreduce":
        local = [entry_b.group.index(p) for p in entry_b.perm]
        sched = R_certified(len(entry_b.group), bb, algo="ring", perm=local,
                            chunk_factor=max(1, entry_b.chunks))
    red = reducer_from_plan(t_plan, SMOKE_PAYLOAD)
    assert red.bucket_bytes == bb
    assert red.schedule.fingerprint() == sched.fingerprint()
    assert red.schedule.order == sched.order
    assert red.schedule.algorithm == "ring" and red.transport == "peer_ring"
    # the runner transport takes the same schedule
    assert reducer_from_plan(t_plan, SMOKE_PAYLOAD,
                             transport="runner").schedule == red.schedule


def test_solver_refuses_the_jax_backend():
    lat, _, _ = _cost_inputs(16, seed=0)
    model = T_cm.make_cost_model("ring", cost_matrix=lat, size_bytes=1e6)
    for call in (lambda: T_so.solve(model, iters=10, chains=2, backend="jax"),
                 lambda: T_so.solve_sa(model, iters=10, chains=2, backend="jax")):
        with pytest.raises(ValueError, match="ROADMAP.md .*item 14"):
            call()
    budget = T_plan.SolveBudget(iters=10, chains=2, backend="jax")
    fab = T_fab.make_datacenter(16, nodes_per_rack=4, seed=0)
    with pytest.raises(ValueError, match="item 14"):
        T_plan.PlanCompiler(budget=budget).compile(
            T_fab.probe_fabric(fab, seed=0), T_train_mix(1e6))
