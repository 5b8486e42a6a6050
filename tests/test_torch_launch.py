"""The port's launch surface against the reference's on the same inputs:
the production, reordered and planned meshes, ``mesh_context``, the HLO
collective accounting and roofline terms, ``JobMix.from_hlo`` (and a plan
compiled from it), the deprecated shims and ``equiv.STAGES``."""

import dataclasses
import json
import sys
import warnings
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.fabric as R_fab  # noqa: E402
import repro.plan as R_plan  # noqa: E402
import repro_torch.fabric as T_fab  # noqa: E402
import repro_torch.plan as T_plan  # noqa: E402
from repro.analysis import equiv as R_equiv  # noqa: E402
from repro.core import reorder as R_re  # noqa: E402
from repro.launch import hlo_analysis as R_ha  # noqa: E402
from repro.launch import mesh as R_mesh  # noqa: E402
from repro_torch.analysis import equiv as T_equiv  # noqa: E402
from repro_torch.core import reorder as T_re  # noqa: E402
from repro_torch.launch import hlo_analysis as T_ha  # noqa: E402
from repro_torch.launch import mesh as T_mesh  # noqa: E402

# tests/test_hlo_analysis.py's sample: a 40-trip while body with an
# all-gather and an all-reduce, an entry collective-permute and
# reduce-scatter
SAMPLE_HLO = """\
HloModule jit_step, entry_computation_layout={()->f32[]}

%wide.body_2 (p: (s32[], f32[128,256])) -> (s32[], f32[128,256]) {
  %ag = bf16[64,512]{1,0} all-gather(%x), replica_groups=[16,16]<=[256]
  %ar = f32[128]{0} all-reduce(%y), to_apply=%add
  ROOT %t = (s32[], f32[128,256]) tuple(%i, %z)
}

%wide.cond_2 (p: (s32[], f32[128,256])) -> pred[] {
  %c40 = s32[] constant(40)
  ROOT %lt = pred[] compare(%i, %c40), direction=LT
}

ENTRY %main.1 (a: f32[4]) -> f32[] {
  %w = (s32[], f32[128,256]) while(%init), condition=%wide.cond_2, body=%wide.body_2
  %cp = f32[1024]{0} collective-permute(%a), source_target_pairs={{0,1}}
  %rs = bf16[32,32]{1,0} reduce-scatter(%b), replica_groups=[4,4]<=[16]
  ROOT %r = f32[] constant(0)
}
"""


@pytest.fixture(scope="module")
def compiled_hlo():
    """Optimized HLO text of a small reference-style step on the one CPU
    device: a scanned body with a psum and an all_gather, a psum outside."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))

    def body(c, x):
        y = jax.lax.psum(x * c, "data")
        return c + jax.lax.all_gather(y, "data").sum(), y

    def inner(x):
        c, ys = jax.lax.scan(body, jnp.zeros(()), x)
        return ys + jax.lax.psum(c, "data")

    f = shard_map(inner, mesh=mesh, in_specs=P(), out_specs=P(),
                  check_vma=False)
    return jax.jit(f).lower(jnp.ones((5, 8, 16), jnp.float32)).compile().as_text()


def _texts(compiled_hlo):
    return {"sample": SAMPLE_HLO, "compiled": compiled_hlo}


# -- meshes -------------------------------------------------------------------

def _mesh_plans(shape, names, seed):
    n = int(np.prod(shape))
    rng = np.random.default_rng(seed)
    c = rng.uniform(1.0, 10.0, (n, n))
    c = (c + c.T) / 2
    np.fill_diagonal(c, 0.0)
    return (R_re.optimize_mesh_assignment(c, shape, names, seed=0),
            T_re.optimize_mesh_assignment(c, shape, names, seed=0))


@pytest.mark.parametrize("shape,names", [
    ((4, 6), ("data", "model")), ((2, 3, 4), ("pod", "data", "model"))])
def test_reordered_and_planned_meshes_equal_the_references(shape, names):
    r, t = _mesh_plans(shape, names, seed=len(shape))
    # the reference's mesh: devices[plan.flat] reshaped, device i as i
    devices = np.asarray(np.arange(r.flat.size), dtype=object)
    want = devices[r.flat].reshape(r.assignment.shape)
    mesh = T_mesh.make_reordered_mesh(t, device="cpu")
    np.testing.assert_array_equal(np.asarray(mesh.order).reshape(mesh.shape),
                                  want.astype(int))
    assert mesh.shape == want.shape and mesh.axis_names == tuple(r.axis_names)
    planned = T_mesh.make_planned_mesh(SimpleNamespace(mesh_plan=t), "cpu")
    assert planned == mesh
    with pytest.raises(ValueError, match="without a mesh shape"):
        T_mesh.make_planned_mesh(SimpleNamespace(mesh_plan=None), "cpu")


def test_reordered_mesh_refuses_a_group_of_another_size(tmp_path):
    """The reference asserts the device count equals the plan's; over a
    process group the port raises on the group's size."""
    import torch.distributed as dist

    _, t = _mesh_plans((2, 2), ("data", "model"), seed=0)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="the group has 1 processes"):
            T_mesh.make_reordered_mesh(t, "cpu", group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_the_references_shape_in_identity_order(multi_pod):
    shape, axes = R_mesh.production_shape(multi_pod)
    assert T_mesh.production_shape(multi_pod) == (shape, axes)
    mesh = T_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert (mesh.shape, mesh.axis_names) == (shape, axes)
    # jax.make_mesh's order on identical devices: 0 .. n-1
    assert mesh.order == tuple(range(int(np.prod(shape))))
    assert not any(isinstance(v, torch.Tensor)
                   for v in dataclasses.asdict(mesh).values())
    with T_mesh.mesh_context(mesh) as got:
        assert got is mesh


# -- HLO accounting -----------------------------------------------------------

@pytest.mark.parametrize("which", ["sample", "compiled"])
@pytest.mark.parametrize("scale_loops", [True, False])
def test_parse_collectives_equals_the_references(compiled_hlo, which,
                                                 scale_loops):
    text = _texts(compiled_hlo)[which]
    r = R_ha.parse_collectives(text, scale_loops=scale_loops)
    t = T_ha.parse_collectives(text, scale_loops=scale_loops)
    assert t.bytes_by_type == r.bytes_by_type
    assert t.count_by_type == r.count_by_type
    assert t.total_bytes == r.total_bytes and t.details == r.details
    assert t.count_by_type  # each text has collectives to count
    if which == "sample" and scale_loops:
        assert t.count_by_type["all-gather"] == 40


def test_roofline_terms_equal_the_references_at_its_constants():
    """The port's ``HW`` holds an H100's datasheet figures; given the
    reference's constants (read from its ``HW()`` here) its terms are the
    reference's."""
    ref_hw = R_ha.HW()
    hw = T_ha.HW(**dataclasses.asdict(ref_hw))
    for args, dcn in (((1e20, 1e10, 1e8, 256), 0.0),
                      ((1e12, 1e10, 1e13, 256), 5e12),
                      ((0, 0, 1e12, 256), 1e12), ((3e15, 2e12, 4e11, 8), 0.0)):
        assert T_ha.roofline_terms(*args, hw, dcn_collective_bytes=dcn) == \
            R_ha.roofline_terms(*args, ref_hw, dcn_collective_bytes=dcn)
    h100 = T_ha.HW()
    assert (h100.peak_flops, h100.hbm_bw, h100.ici_bw, h100.dcn_bw,
            h100.hbm_per_chip) == (989.4e12, 3.35e12, 450e9, 50e9, 80e9)
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in " ".join(T_ha.__doc__.split())


def _mix_rows(mix):
    return [(q.op, q.size_bytes, q.count, q.group) for q in mix.requests]


@pytest.mark.parametrize("which", ["sample", "compiled"])
def test_job_mix_from_hlo_equals_the_references(compiled_hlo, which):
    text = _texts(compiled_hlo)[which]
    for scale_loops in (True, False):
        r = R_plan.JobMix.from_hlo(text, name=which, scale_loops=scale_loops)
        t = T_plan.JobMix.from_hlo(text, name=which, scale_loops=scale_loops)
        assert t.key() == r.key() and t.name == r.name
        assert _mix_rows(t) == _mix_rows(r) and _mix_rows(t)
        assert all(q.op != "collective-permute" for q in t.requests)


def test_plan_compiled_from_an_hlo_mix_equals_the_references():
    def plan(F, P):
        fab, _ = F.scramble(F.make_datacenter(8, nodes_per_rack=4,
                                              racks_per_agg=2, seed=0), seed=1)
        return P.PlanCompiler(fabric=fab, seed=0).compile(
            F.probe_fabric(fab, seed=0), P.JobMix.from_hlo(SAMPLE_HLO),
            mesh_shape=(8,))

    r, t = plan(R_fab, R_plan), plan(T_fab, T_plan)
    rd, td = json.loads(r.to_json()), json.loads(t.to_json())
    rd.pop("compile_seconds"), td.pop("compile_seconds")
    assert td == rd and len(t.entries) == 3


# -- the shims ------------------------------------------------------------------

def test_equiv_stages_are_the_references():
    from repro.collective import CollectiveOp as R_Op, compile_op as r_compile
    from repro_torch.collective import CollectiveOp as T_Op, compile_op as t_compile

    assert T_equiv.STAGES == R_equiv.STAGES
    r = R_equiv.certify_stages(r_compile(R_Op("allreduce", 64.0, range(4)),
                                         "ring"), perm=(2, 0, 3, 1), chunk_k=2)
    t = T_equiv.certify_stages(t_compile(T_Op("allreduce", 64.0, range(4)),
                                         "ring"), perm=(2, 0, 3, 1), chunk_k=2)
    assert [v["stage"] for v in t] == [v["stage"] for v in r] == \
        list(T_equiv.STAGES)


@pytest.mark.parametrize("moe", [False, True])
def test_job_mix_shims_warn_and_equal_the_mixes(moe):
    from repro_torch.launch import serve as T_serve
    from repro_torch.launch import train as T_train
    from repro_torch.session import serve_mix, train_mix

    for shim, mix in ((T_serve.serve_job_mix, serve_mix),
                      (T_train.default_job_mix, train_mix)):
        with pytest.warns(DeprecationWarning, match="is deprecated") as rec:
            got = shim(4e6, moe=moe)
        assert rec[0].filename == __file__      # stacklevel=2: the caller
        assert got.key() == mix(4e6, moe=moe).key()
        assert _mix_rows(got) == _mix_rows(mix(4e6, moe=moe))


@pytest.mark.parametrize("command", ["serve", "train"])
def test_launch_mains_delegate_to_the_cli(monkeypatch, command):
    import importlib

    from repro_torch import cli

    module = importlib.import_module(f"repro_torch.launch.{command}")
    calls = []
    monkeypatch.setattr(cli, "main", lambda argv: calls.append(argv) or 3)
    monkeypatch.setattr(sys, "argv", ["launch", "--smoke", "--device", "cpu"])
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with pytest.raises(DeprecationWarning, match=f"repro_torch {command}"):
            module.main()
    with pytest.warns(DeprecationWarning):
        with pytest.raises(SystemExit) as exit_:
            module.main()
    assert exit_.value.code == 3
    assert calls == [[command, "--smoke", "--device", "cpu"]]


def test_launch_package_is_lazy_and_resolves_names_at_access():
    """``repro_torch.launch``'s ``__init__`` imports no submodule, as the
    reference's; a re-exported name is looked up in its module each time,
    so a patch of the module reaches it."""
    import ast

    import repro_torch.launch as launch

    tree = ast.parse(open(launch.__file__, encoding="utf-8").read())
    imported = [n for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert [(type(n).__name__, getattr(n, "module", None)) for n in imported] \
        == [("ImportFrom", "importlib")]
    assert launch.make_production_mesh is T_mesh.make_production_mesh
    sentinel = object()
    orig = T_mesh.make_production_mesh
    T_mesh.make_production_mesh = sentinel
    try:
        assert launch.make_production_mesh is sentinel
    finally:
        T_mesh.make_production_mesh = orig
    assert launch.hlo_analysis is T_ha and set(launch.__all__) >= {
        "hlo_analysis", "serve", "mesh", "specs", "train"}
