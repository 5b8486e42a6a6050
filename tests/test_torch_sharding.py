"""The port's partition rules, ``launch/specs`` and ``sp_*`` against the
reference's, spec for spec.

The reference's rules read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in mesh serves any shape in a
one-device process; each arch's parameter and cache shapes come from one
cached ``jax.eval_shape``.  The port's come from meta tensors.
"""

import functools
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShapeSpec  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.launch.mesh import make_mesh_for_tests  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.train.train_step import TrainState as JaxTrainState  # noqa: E402
from repro.train.train_step import batch_pspecs as jax_batch_pspecs  # noqa: E402
from repro.train.train_step import state_pspecs as jax_state_pspecs  # noqa: E402
from repro_torch.configs import SHAPES, get_config, shape_applicable  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLM, batches, host_batch, make_global_batch  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import PlannedMesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.train.sharded_step import param_shapes  # noqa: E402
from repro_torch.train.train_step import TrainState, batch_pspecs, state_pspecs  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MESHES = [((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
CACHE_B, CACHE_S = 32, 64


@pytest.fixture(autouse=True)
def _reset_sp():
    yield
    L.clear_sequence_parallel()


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, object))


def _port_mesh(shape, axes, order=None):
    n = int(np.prod(shape))
    return PlannedMesh(order=tuple(order) if order is not None else tuple(range(n)),
                       shape=shape, axis_names=axes, device=torch.device("cpu"))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    """One ``eval_shape`` of the parameters and one of the cache an arch."""
    m = jax_get_model(jax_get_config(arch))
    params = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: m.init_cache(CACHE_B, CACHE_S))
    return params, cache


def _ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_specs(tree):
    return [tuple(s) for s in tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_state_and_cache_specs_equal_the_reference(arch):
    jparams, jcache = _ref_shapes(arch)
    cfg = get_config(arch)
    model = specs._meta_model(cfg)
    params = param_shapes(model)
    cache = model.init_cache(CACHE_B, CACHE_S)
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [tuple(t.shape) for t in jax.tree.leaves(jparams)]
    jcfg = jax_get_config(arch)
    for shape, axes in MESHES:
        jmesh, mesh = _stand_in(shape, axes), _port_mesh(shape, axes)
        js = jax_state_pspecs(JaxTrainState(params=jparams, opt=None, step=None),
                              jcfg, jmesh)
        ps = state_pspecs(TrainState(params=params, opt=None, step=None), cfg, mesh)
        assert _port_specs(ps.params) == _ref_specs(js.params), (arch, shape)
        assert _port_specs(ps.opt.m) == _ref_specs(js.opt.m), (arch, shape)
        assert _port_specs(ps.opt.v) == _ref_specs(js.opt.v)
        assert tuple(ps.opt.count) == tuple(js.opt.count) == ()
        assert _port_specs(shd.param_pspecs(params, cfg, mesh)) == \
            _ref_specs(jshd.param_pspecs(jparams, jcfg, jmesh))
        assert _port_specs(shd.cache_pspecs(cache, cfg, mesh)) == \
            _ref_specs(jshd.cache_pspecs(jcache, jcfg, jmesh)), (arch, shape)


@pytest.mark.parametrize("shape,axes", MESHES)
def test_mesh_helpers_equal_the_reference(shape, axes):
    jmesh, mesh = _stand_in(shape, axes), _port_mesh(shape, axes)
    assert shd.mesh_axis_sizes(mesh) == jshd.mesh_axis_sizes(jmesh)
    assert shd.dp_axes(mesh) == jshd.dp_axes(jmesh)
    assert tuple(shd.batch_spec(mesh)) == tuple(jshd.batch_spec(jmesh))
    batch = {"tokens": np.zeros((64, 8), np.int32), "frontend_embeds":
             np.zeros((64, 4, 2), np.float32)}
    assert {k: tuple(v) for k, v in batch_pspecs(batch, mesh).items()} == \
        {k: tuple(v) for k, v in jax_batch_pspecs(batch, jmesh).items()}
    # zero1 on an axis the spec already uses, and where nothing divides
    for spec, dims in [(("data", None, "model"), (8, 6, 4)),
                       ((None, "model"), (3, 5)), ((None, None), (64, 7))]:
        assert tuple(shd.zero1_spec(shd.P(*spec), dims, mesh)) == \
            tuple(jshd.zero1_spec(JP(*spec), dims, jmesh))
    named = shd.named_shardings({"a": shd.P("data")}, mesh)
    assert named["a"].mesh is mesh and tuple(named["a"].spec) == ("data",)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_equal_the_reference(kind):
    """The three smoke cells of ``tests/test_launch_specs.py`` at the
    reference's ``(1, 1)`` mesh: every stand-in's shape, dtype and spec."""
    want = jax_specs.input_specs(jax_get_config("qwen2-0.5b").smoke(),
                                 JaxShapeSpec(f"tiny_{kind}", 16, 4, kind),
                                 make_mesh_for_tests((1, 1), ("data", "model")))
    got = specs.input_specs(get_config("qwen2-0.5b").smoke(),
                            ShapeSpec(f"tiny_{kind}", 16, 4, kind),
                            _port_mesh((1, 1), ("data", "model")))
    jl = jax.tree.leaves(want)
    pl = tree_leaves(got)
    assert len(jl) == len(pl) and len(got) == len(want)
    for j, p in zip(jl, pl):
        assert p.tensor.device.type == "meta"
        assert p.shape == tuple(j.shape)
        assert str(p.dtype).split(".")[-1] == str(j.dtype), (p.dtype, j.dtype)
        assert tuple(p.spec) == tuple(j.sharding.spec)
    assert callable(specs.step_callable(get_config("qwen2-0.5b").smoke(),
                                        ShapeSpec("t", 16, 4, kind), "cpu"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_of_every_cell_allocate_nothing(arch):
    """Every cell ``shape_applicable`` allows, on the production mesh
    shape of the reference's dry-run (2x16x16 for MoE, 16x16 else): each
    stand-in is a meta tensor whose spec has one entry a dimension."""
    cfg = get_config(arch)
    shape = (2, 16, 16) if cfg.n_experts else (16, 16)
    axes = ("pod", "data", "model")[-len(shape):]
    mesh = _port_mesh(shape, axes)
    for cell in SHAPES.values():
        if not shape_applicable(cfg, cell)[0]:
            continue
        leaves = tree_leaves(specs.input_specs(cfg, cell, mesh))
        assert leaves and all(isinstance(x, specs.MetaSpec) for x in leaves)
        assert all(x.tensor.device.type == "meta" and
                   len(x.spec) <= len(x.shape) for x in leaves), (arch, cell)


def test_sp_guards_equal_the_reference(monkeypatch):
    """Armed as ``configure_sp`` arms a (data, model) mesh of model 4, each
    ``sp_*`` asks for the reference's layout, or for none where the
    reference's guard passes the tensor through; the value is the input."""
    asked = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: asked.append(tuple(spec)) or x)
    cfg, jcfg = get_config("qwen2-0.5b"), jax_get_config("qwen2-0.5b")
    specs.configure_sp(cfg, _port_mesh((2, 4), ("data", "model")))
    jax_specs.configure_sp(jcfg, _stand_in((2, 4), ("data", "model")))
    cases = [("sp_constrain", (2, 8, 6), ()), ("sp_constrain", (2, 6, 6), ()),
             ("sp_constrain", (8, 6), ()),
             ("sp_shard_heads", (2, 8, 3, 4), (8,)),
             ("sp_shard_heads", (2, 6, 3, 4), (6,)),
             ("sp_head_constrain", (6, 16), ()), ("sp_head_constrain", (6, 10), ()),
             ("sp_gather_kv", (2, 4, 3, 4), (cfg,)),
             ("sp_gather_kv", (2, 2, 3, 4), (cfg,)),
             ("sp_gather_kv", (2, 3, 4), (cfg,))]
    for name, dims, extra in cases:
        asked.clear()
        L._SP_STATE["asked"].clear()
        x = torch.zeros(dims)
        assert getattr(L, name)(x, *extra) is x
        getattr(JL, name)(jnp.zeros(dims), *[jcfg if e is cfg else e for e in extra])
        got = L._SP_STATE["asked"].get(name)
        assert (tuple(got) if got is not None else None) == \
            (asked[0] if asked else None), (name, dims)
    L.clear_sequence_parallel()
    assert L.sp_constrain(torch.zeros(2, 8, 6)) is not None
    assert L._SP_STATE["asked"] == {} and L._SP_STATE["tp"] is None


@pytest.mark.parametrize("arch,asked", [
    ("qwen2-0.5b", {"sp_constrain", "sp_gather_kv", "sp_head_constrain"}),
    ("llava-next-mistral-7b", {"sp_constrain", "sp_gather_kv", "sp_head_constrain"}),
    ("deepseek-v2-236b", {"sp_constrain", "sp_shard_heads", "sp_head_constrain"}),
    ("rwkv6-1.6b", {"sp_constrain", "sp_head_constrain"}),
    ("recurrentgemma-9b", {"sp_constrain", "sp_gather_kv", "sp_head_constrain"}),
    ("whisper-small", {"sp_constrain", "sp_gather_kv", "sp_head_constrain"})])
def test_every_family_asks_at_the_references_call_sites(arch, asked):
    """Armed by ``configure_sp`` on a (data, model) mesh, a smoke loss of
    each family reaches the reference's call sites: every block's
    ``sp_constrain`` (``transformer.py:89``, ``rwkv6.py:210``,
    ``rglru.py:215``, ``whisper.py:138``), the attention's
    ``sp_gather_kv`` (``layers.py:281-282``), MLA's ``sp_shard_heads``
    (``layers.py:523-526``) and the loss head's ``sp_head_constrain``
    (``transformer.py:336``)."""
    from repro_torch.models import get_model

    cfg = get_config(arch).smoke()
    specs.configure_sp(cfg, _port_mesh((1, 2), ("data", "model")))
    model = get_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.long),
             "labels": torch.zeros(2, 8, dtype=torch.long)}
    if cfg.family == "encdec":
        batch["frontend_embeds"] = torch.zeros(2, cfg.n_audio_ctx, cfg.d_model)
    with torch.no_grad():
        model.loss(model.init(gen), batch)
    assert set(L._SP_STATE["asked"]) == asked


@pytest.mark.parametrize("shape,axes,seed", [
    ((4, 2), ("data", "model"), 0), ((2, 2, 2), ("pod", "data", "model"), 1),
    ((8,), ("data",), 2)])
def test_make_global_batch_rows_equal_the_reference(shape, axes, seed):
    """Rank ``r`` holds the rows of its slot's dp index, replicated over
    the model axis, bit for bit the reference's ``batch_rows``."""
    n = int(np.prod(shape))
    order = np.random.default_rng(seed).permutation(n)
    mesh = _port_mesh(shape, axes, order)
    ds = SyntheticLM(256, 12, 8, seed=3)
    jds = JaxSyntheticLM(256, 12, 8, seed=3)
    got = make_global_batch(ds, 2, mesh, shd.batch_spec(mesh))
    sizes = dict(zip(axes, shape))
    dp = int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
    per = 8 // dp
    for rank in range(n):
        coords = np.unravel_index(list(order).index(rank), shape)
        k = int(np.ravel_multi_index(coords[:len(shape) - ("model" in axes)],
                                     shape[:len(shape) - ("model" in axes)]))
        want = jds.batch_rows(2, np.arange(k * per, (k + 1) * per))
        for name in ("tokens", "labels"):
            np.testing.assert_array_equal(got[name][rank], want[name])
    if axes == ("data",):   # the 1-D mesh's placement, PlannedMesh.batch_rows
        rows = host_batch(ds, 2)["tokens"][mesh.batch_rows(8)]
        np.testing.assert_array_equal(got["tokens"].reshape(8, -1), rows)
    it = batches(ds, mesh, shd.batch_spec(mesh), start_step=2)
    np.testing.assert_array_equal(next(it)["labels"], got["labels"])
    np.testing.assert_array_equal(next(batches(ds))["tokens"],
                                  host_batch(ds, 0)["tokens"])
