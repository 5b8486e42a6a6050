"""The process-group runner: certified schedules over 8 gloo processes.

One spawn of 8 processes runs every case (the reference runs its
schedules over ``ppermute`` on 8 devices, ``tests/test_system.py:124-141``):
the certified ring all-reduce at the reference test's rank order in f32 and
bf16, a ``chunk_factor`` 2 ring, a plan's all-gather from
``Session.lower``, each on the group-backed mesh ``make_planned_mesh``
builds from the plan, and the f32 ring on the identity order too (the
placement changes which process runs a position, not its row).  Every
row is held bit for bit to the virtual-mesh runner on the same inputs,
and the rings to the reference's ``ring_reduce_scatter_ref`` (atol 1e-4,
as the reference's test).  In the same spawn, each held to the virtual
mesh on the same inputs: the pipeline (``tests/test_system.py:143-170``'s
8 stages of ``tanh(x @ w)``, stage ``i`` in the process holding slot
``i`` of the plan's mesh) forward and backward, every process
backpropagating its own loss, those of all but stage 0's process scaled
by 7, and the stages' gradients the virtual pipeline's, not 8 or 7 times
them; the EP all-to-all on the smoke ``dbrx-132b`` with 8 experts (one a
process, half of the processes holding only theirs) in the shift order
of a plan of ``serve_mix(moe=True)``, bit for bit with its aux loss; and
``compressed_psum``, bit for bit.  The bf16 inputs lie on a grid of 1/4 in [-2, 2], so every partial
sum of 8 of them is exact in bf16 and the same atol holds.

Spawned processes import this file, so it imports neither JAX nor the
reference at the top: those imports sit inside the test bodies.
"""

import datetime
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.analysis import VerificationError, require_certified  # noqa: E402
from repro_torch.collective import (  # noqa: E402
    CollectiveOp,
    ScheduleLowering,
    apply_permutation,
    chunk,
    compile_op,
)
from repro_torch.kernels.group_runner import (  # noqa: E402
    gather_rows,
    local_rank,
    reduce_count,
    run_schedule_group,
)
from repro_torch.kernels.schedule_runner import (  # noqa: E402
    check_postcondition,
    run_schedule,
)

N = 8
MESH_PERM = [0, 3, 1, 7, 2, 6, 4, 5]          # tests/test_system.py:134-141
WIDTH = 64                                     # the reference test's (8, 64)
SPAWN_TIMEOUT_S = 120
SESSION_CFG = {
    "fabric": {"kind": "datacenter", "nodes": N, "scramble_seed": 1},
    "probe": {"n_probes": 64},
    "solver": {"budget": {"iters": 300, "chains": 2}},
    "mesh": {"shape": [N], "axis_names": ["data"]},
    "workload": "serve",
    "payload_bytes": 1e6,
}


def _ring(perm, chunk_factor=1):
    """A certified ring all-reduce's ``(program, schedule)`` pair."""
    prog = compile_op(CollectiveOp(kind="allreduce", size_bytes=WIDTH * 4.0,
                                   group=tuple(range(N))), "ring")
    prog = apply_permutation(prog, list(perm))
    if chunk_factor > 1:
        prog = chunk(prog, chunk_factor)
    return prog, ScheduleLowering().lower_schedule(prog)


def _to_port(schedule):
    """A reference ``LoweredSchedule`` field for field in the port's IR."""
    import dataclasses

    from repro_torch.collective import LoweredSchedule, PermuteStep

    rounds = tuple(tuple(PermuteStep(**{f.name: getattr(s, f.name)
                                        for f in dataclasses.fields(PermuteStep)})
                         for s in rnd) for rnd in schedule.rounds)
    fields = {f.name: getattr(schedule, f.name)
              for f in dataclasses.fields(LoweredSchedule) if f.name != "rounds"}
    return LoweredSchedule(rounds=rounds, **fields)


def _group_mesh(order, group=None):
    """A one-axis planned mesh over ``order`` whose ranks are ``group``'s
    processes (what ``make_planned_mesh`` builds from a plan)."""
    from repro_torch.launch import PlannedMesh

    return PlannedMesh(order=tuple(order), shape=(N,), axis_names=("data",),
                       device=torch.device("cpu"), group=group)


def _pipeline_stage(w, x):
    return torch.tanh(x @ w)


def _port_cases(plan, extra):
    """The pipeline, EP and compression cases in this process: what it
    holds of each, gathered to every process."""
    from repro_torch.launch import make_planned_mesh
    from repro_torch.models import layers as L
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.parallel import moe_a2a
    from repro_torch.parallel.pipeline import pipeline_loss

    mesh = make_planned_mesh(plan, "cpu", group=dist.group.WORLD)
    ws, xs = extra["pipeline"]
    w = torch.tensor(ws, requires_grad=True)
    loss = pipeline_loss(_pipeline_stage, lambda y, _: torch.sum(y ** 2), w,
                         torch.tensor(xs), None, mesh, axis="data")
    # only stage 0's process's loss counts, as the reference's out[0]
    (loss * (1.0 if mesh.slot == 0 else 7.0)).backward()
    others = torch.cat([w.grad[:mesh.slot], w.grad[mesh.slot + 1:]])
    mine = {"pipeline": (mesh.slot, w.grad[mesh.slot].clone(),
                         bool(others.any()), loss.detach())}

    cfg, p, x, ep_plan = extra["ep"]
    ep_mesh = make_planned_mesh(ep_plan, "cpu", group=dist.group.WORLD)
    moe_a2a.arm_ep(ep_mesh, "data", None, plan=ep_plan)
    try:
        r = moe_a2a.ep_rank()
        if r % 2:           # this rank's experts only
            p = dict(p, **{k: p[k][r:r + 1] for k in ("w1", "w3", "w2")})
        with torch.no_grad():
            y, aux = L.moe_layer(p, x[r:r + 1], cfg)
        mine["ep"] = (r, y, aux, moe_a2a._EP_STATE["a2a_order"])
    finally:
        moe_a2a.clear_ep()
    xc = torch.tensor(extra["compression"])
    mine["compression"] = (mesh.slot, compressed_psum(xc[mesh.slot], mesh))
    got = [None] * N
    dist.all_gather_object(got, mine)
    return {k: [g[k] for g in got] for k in mine}


def _worker(rank, store, cases, plan, out, extra):
    """One process of the group: every case on its mesh (the plan's, or
    the identity order), rows gathered to rank 0; then the port's
    pipeline, EP and compression cases."""
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=N, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from repro_torch.launch import make_planned_mesh

        meshes = {"plan": make_planned_mesh(plan, "cpu", group=dist.group.WORLD),
                  "identity": _group_mesh(range(N), dist.group.WORLD)}
        got = {}
        for name, (artifact, x, on) in cases.items():
            sched = artifact.schedule if hasattr(artifact, "schedule") \
                else artifact[1]
            mesh, stats = meshes[on], {}
            row = run_schedule_group(x[local_rank(sched, mesh)], artifact,
                                     mesh, stats=stats)
            assert stats["rounds"] == len(sched.rounds) * sched.chunk_factor
            got[name] = gather_rows(row, sched, mesh)
        slots = [None] * N
        dist.all_gather_object(slots, meshes["plan"].slot)
        got["slots"] = slots
        got.update(_port_cases(plan, extra))
        half = dist.new_group(list(range(N // 2)))
        if rank < N // 2:
            try:
                make_planned_mesh(plan, "cpu", group=half)
            except ValueError as e:
                got["half"] = str(e)
        if rank == 0:
            torch.save(got, out)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, cases, plan, extra):
    out = str(tmp_path / "rows.pt")
    ctx = mp.start_processes(_worker, args=(str(tmp_path / "store"), cases,
                                            plan, out, extra),
                             nprocs=N, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {N} processes did not finish in "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
    return torch.load(out)


def test_certified_schedules_over_8_gloo_processes(tmp_path):
    import jax.numpy as jnp

    from repro.kernels.ref import ring_reduce_scatter_ref
    from repro_torch.session import Session, SessionConfig

    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.standard_normal((N, WIDTH)).astype(np.float32))
    x16 = torch.from_numpy(rng.integers(-8, 9, (N, WIDTH)) / 4.0).to(torch.bfloat16)
    ring, ring2 = _ring(MESH_PERM), _ring(MESH_PERM, chunk_factor=2)
    with Session(SessionConfig.from_dict(SESSION_CFG)) as s:
        plan = s.plan()
        ag = s.lower("all-gather")
    x_ag = torch.from_numpy(rng.standard_normal((N, 24)).astype(np.float32))
    # group rank i is position i on the identity mesh; on the plan's mesh
    # position i lives in the process at group rank order[i]
    cases = {"ring_f32": (ring, x32, "identity"),
             "ring_f32_planned": (ring, x32, "plan"),
             "ring_bf16": (ring, x16, "plan"), "ring_k2": (ring2, x32, "plan"),
             "all_gather": (ag, x_ag, "plan")}
    extra, virtual = _port_inputs(rng)
    got = _spawn(tmp_path, cases, plan, extra)

    for name, (artifact, x, _) in cases.items():
        sched = artifact.schedule if name == "all_gather" else artifact[1]
        want = run_schedule(x, sched)
        assert got[name].dtype == x.dtype and torch.equal(got[name], want), name
        assert check_postcondition(sched, x, got[name]) == [], name
        if name != "all_gather":
            oracle = np.asarray(ring_reduce_scatter_ref(
                jnp.asarray(x.float().numpy()), N))       # [n, D / n]
            for r in range(N):
                np.testing.assert_allclose(got[name][r].float().numpy(),
                                           oracle, atol=1e-4)
    assert ag.schedule.postcondition == "all_gather"
    order = [int(i) for i in plan.mesh_plan.flat]
    assert order != list(range(N))      # the two meshes place differently
    assert got["slots"] == [order.index(r) for r in range(N)]
    assert "the group has 4 processes" in got["half"]
    _check_port_cases(got, virtual)


def _port_inputs(rng):
    """The pipeline, EP and compression cases' inputs, and their runs on
    the virtual mesh."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.fabric import make_datacenter, probe_fabric, scramble
    from repro_torch.launch import make_mesh, make_planned_mesh
    from repro_torch.models import layers as L
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.parallel import moe_a2a
    from repro_torch.parallel.pipeline import pipeline_loss
    from repro_torch.plan import PlanCompiler
    from repro_torch.session import serve_mix

    ws = (np.random.default_rng(1).standard_normal((N, 16, 16)) * 0.3
          ).astype(np.float32)
    xs = np.random.default_rng(2).standard_normal((4, 2, 16)).astype(np.float32)
    w = torch.tensor(ws, requires_grad=True)
    loss = pipeline_loss(_pipeline_stage, lambda y, _: torch.sum(y ** 2), w,
                         torch.tensor(xs), None,
                         make_mesh((N,), ("stage",), device="cpu"))
    loss.backward()

    cfg = dataclasses.replace(get_config("dbrx-132b").smoke(), n_experts=N)
    gen = torch.Generator().manual_seed(0)
    p = L.init_from_spec(gen, L.moe_spec(cfg), torch.float32)
    x = torch.randn(N, 16, cfg.d_model, generator=gen)
    fab, _ = scramble(make_datacenter(N, nodes_per_rack=4, racks_per_agg=2,
                                      seed=0), seed=1)
    ep_plan = PlanCompiler(fabric=fab, seed=0, device="cpu").compile(
        probe_fabric(fab, seed=0), serve_mix(1e6, moe=True), mesh_shape=(N,),
        axis_names=("data",))
    moe_a2a.arm_ep(make_planned_mesh(ep_plan, "cpu"), "data", None,
                   plan=ep_plan)
    try:
        with torch.no_grad():
            y, aux = moe_a2a.moe_a2a(p, x, cfg)
        order = moe_a2a._EP_STATE["a2a_order"]
    finally:
        moe_a2a.clear_ep()
    assert order is not None and list(order) != list(range(N))

    xc = (rng.standard_normal((N, 100)) * np.logspace(-3, 0, N)[:, None]
          ).astype(np.float32)
    mesh = make_mesh((N,), ("data",), device="cpu")
    extra = {"pipeline": (ws, xs), "ep": (cfg, p, x, ep_plan),
             "compression": xc}
    virtual = {"pipeline": (w.grad, loss.detach()), "ep": (y, aux, order),
               "compression": compressed_psum(torch.tensor(xc), mesh)}
    return extra, virtual


def _check_port_cases(got, virtual):
    grad, loss = virtual["pipeline"]
    slots = sorted(got["pipeline"], key=lambda g: g[0])
    assert [s[0] for s in slots] == list(range(N))
    # each stage's gradient is the virtual pipeline's: not 8 (or 7) times it
    for slot, g, others_nonzero, loss_p in slots:
        assert torch.equal(g, grad[slot]), slot
        assert not others_nonzero
        assert torch.equal(loss_p, loss)
    y, aux, a2a_order = virtual["ep"]
    ranks = sorted(got["ep"], key=lambda g: g[0])
    assert [r[0] for r in ranks] == list(range(N))
    assert all(r[3] == a2a_order for r in ranks)
    assert torch.equal(torch.cat([r[1] for r in ranks]), y)
    assert all(torch.equal(r[2], aux) for r in ranks)
    rows = sorted(got["compression"], key=lambda g: g[0])
    assert all(torch.equal(row, virtual["compression"][slot])
               for slot, row in rows)


def test_runner_refuses_a_bare_schedule_before_any_exchange():
    from repro_torch.collective import Lowered

    prog, sched = _ring(MESH_PERM)
    mesh = _group_mesh(MESH_PERM)
    assert not dist.is_initialized()
    with pytest.raises(TypeError, match="bare LoweredSchedule"):
        run_schedule_group(torch.zeros(WIDTH), sched, mesh)
    with pytest.raises(TypeError, match="Lowered or a"):
        run_schedule_group(torch.zeros(WIDTH), [prog, sched], mesh)
    # a Lowered built by hand, without the program to certify it against
    with pytest.raises(ValueError, match="no program"):
        run_schedule_group(torch.zeros(WIDTH),
                           Lowered(kind="ring", order=(), links=(),
                                   schedule=sched), mesh)
    # certified, then refused for a mesh whose ranks are not processes
    with pytest.raises(ValueError, match="group-backed mesh"):
        run_schedule_group(torch.zeros(WIDTH), (prog, sched), mesh)
    assert not dist.is_initialized()


@pytest.mark.parametrize("perm", [MESH_PERM, list(range(N))])
def test_runner_refuses_the_reference_lowering_mutants(perm):
    """Every mutant ``repro.analysis.mutate.lowering_mutants`` draws of the
    ring, carried into the port's IR, is refused before any exchange: as a
    ``(program, schedule)`` pair and inside a ``Lowered`` of the program."""
    import dataclasses

    from repro.collective import CollectiveOp as RefOp
    from repro.collective import compile_op as ref_compile
    from repro.collective.passes import apply_permutation as ref_permute
    from repro.analysis.mutate import lowering_mutants

    prog, sched = _ring(perm)
    require_certified(prog, sched)
    ref = ref_permute(ref_compile(RefOp(kind="allreduce", size_bytes=WIDTH * 4.0,
                                        group=tuple(range(N))), "ring"), perm)
    assert ref.fingerprint() == prog.fingerprint()
    lowered = ScheduleLowering().lower(prog)
    assert lowered.program is prog and lowered.schedule == sched
    mesh = _group_mesh(perm)
    mutants = lowering_mutants(ref, seed=0)
    assert mutants
    for kind, m in mutants:
        mutant = _to_port(m)
        assert mutant.fingerprint() == m.fingerprint()
        with pytest.raises(VerificationError):
            run_schedule_group(torch.zeros(WIDTH), (prog, mutant), mesh)
        with pytest.raises(VerificationError):
            run_schedule_group(torch.zeros(WIDTH),
                               dataclasses.replace(lowered, schedule=mutant),
                               mesh)
    assert not dist.is_initialized()


def test_reduce_count_is_one_a_reduce_step_a_piece():
    for k in (1, 2):
        _, sched = _ring(MESH_PERM, chunk_factor=k)
        # a ring all-reduce: n - 1 reduce rounds land on every position
        assert [reduce_count(sched, p) for p in range(N)] == [(N - 1) * k] * N
