"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun`` and against real runs: the copied
formulas of every (arch x shape) cell, one rank's train state at the
production mesh, the 80 cells' statuses, the meta count against a real
step of the same smoke cell, the count against XLA's ``cost_analysis``,
and the command in process."""

import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import get_config as R_get_config  # noqa: E402
from repro.launch import hlo_analysis as R_ha  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels.accounting import KernelWork  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_analysis as T_ha  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.specs import _meta_model  # noqa: E402
from repro_torch.launch.train import build_train_step  # noqa: E402
from repro_torch.models.layers import clear_sequence_parallel  # noqa: E402
from repro_torch.parallel import moe_a2a  # noqa: E402


@pytest.fixture(scope="module")
def R_dry():
    """The reference's module; its import sets ``XLA_FLAGS`` for 512 host
    devices, which is put back so the worker's JAX keeps its one."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


@pytest.fixture(autouse=True)
def _clear_contexts():
    yield
    moe_a2a.clear_ep()
    clear_sequence_parallel()


CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def test_copied_formulas_equal_the_references(R_dry):
    """``_model_flops``, ``_depth_variant``, ``_full_units`` and
    ``_finish_roofline`` of every cell, the roofline at the reference's
    rates passed to the port's ``HW``, with and without a depth
    difference."""
    hw = T_ha.HW(**dataclasses.asdict(R_ha.HW()))
    for arch, shape_name in CELLS:
        cfg, rcfg = get_config(arch), R_get_config(arch)
        shape, rshape = SHAPES[shape_name], R_SHAPES[shape_name]
        assert D._model_flops(cfg, shape) == R_dry._model_flops(rcfg, rshape)
        assert D._full_units(cfg) == R_dry._full_units(rcfg)
        for n in (1, 2):
            assert dataclasses.asdict(D._depth_variant(cfg, n)) == \
                dataclasses.asdict(R_dry._depth_variant(rcfg, n))
            assert D._diff_layers(cfg, n) == R_dry._diff_layers(rcfg, n)
        for pd in ({}, {"flops_total": 3.5e15, "bytes_total": 2e12,
                        "coll_total": 1e9}):
            rec = {"per_device": dict(pd),
                   "cost_analysis_raw": {"flops": 7e14, "bytes_accessed": 3e11},
                   "collectives": {"total_bytes": 4e9}}
            ref = json.loads(json.dumps(rec))
            D._finish_roofline(rec, cfg, shape, 256, hw)
            R_dry._finish_roofline(ref, rcfg, rshape, 256)
            assert rec == ref, (arch, shape_name)


def _ref_rank_bytes(arch, shape_name, multi_pod=False):
    """The reference's per-device bytes of a train cell's state and batch
    at ``(16, 16)`` (``(2, 16, 16)`` with ``multi_pod``): each leaf of
    ``jax.eval_shape`` of the state divided by the sizes of the axes its
    ``state_pspecs`` spec names."""
    from repro.models import get_model as R_get_model
    from repro.optim import OptState as R_OptState
    from repro.train.train_step import TrainState as R_TrainState
    from repro.train.train_step import state_pspecs as R_state_pspecs

    rcfg = R_get_config(arch)
    model = R_get_model(rcfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    f32 = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, np.float32),
                       params)
    i32 = jax.ShapeDtypeStruct((), np.int32)
    state = R_TrainState(params=params, opt=R_OptState(m=f32, v=f32, count=i32),
                         step=i32)
    sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    mesh = SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.empty(tuple(sizes.values()), object))
    specs = R_state_pspecs(state, rcfg, mesh)

    def per_device(leaf, spec):
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        for part in spec:
            for axis in (part if isinstance(part, tuple) else (part,)):
                if axis is not None:
                    n //= sizes[axis]
        return n

    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    total = sum(per_device(leaf, spec) for leaf, spec in zip(
        jax.tree.leaves(state), jax.tree.leaves(specs, is_leaf=is_spec)))
    shape = R_SHAPES[shape_name]
    # tokens and labels, int32 [B, S] split over the data-parallel ranks
    dp = sizes["data"] * sizes.get("pod", 1)
    return total + 2 * shape.global_batch // dp * shape.seq_len * 4


@pytest.mark.parametrize("arch,multi_pod", [
    pytest.param("qwen2-0.5b", False, id="qwen2-0.5b"),
    pytest.param("dbrx-132b", False, id="dbrx-132b"),
    pytest.param("deepseek-v2-236b", False, id="deepseek-v2-236b"),
    pytest.param("deepseek-v2-236b", True, id="deepseek-v2-236b-multi-pod")])
def test_one_ranks_train_state_at_the_production_mesh(arch, multi_pod):
    """Rank 0's share of the state and batch the port's step takes at
    ``(16, 16)`` (and deepseek-v2's at ``(2, 16, 16)``, its experts'
    moments sliced over the pods), read from the step's views, equals the
    reference's pspec-derived bytes (qwen2-0.5b 0.1806 GB, dbrx-132b
    6.896 GB a device before the batch)."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    build = build_train_step(cfg, mesh, "cpu", model=_meta_model(cfg))
    shape = SHAPES["train_4k"]
    dp = build.layout["dp"]
    rows = (mesh.size, shape.global_batch // dp, shape.seq_len)
    batch = {k: torch.empty(rows, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    port = D._rank_state_bytes(build, build.state()) + \
        D._rank_batch_bytes(build, batch)
    assert port == _ref_rank_bytes(arch, "train_4k", multi_pod)
    assert build.kind == {"qwen2-0.5b": "tensor_parallel"}.get(arch, "ep")


def test_the_80_cells_statuses():
    """Every cell of both production meshes is the reference's
    ``shape_applicable`` but for the port's 10 refusals, each naming its
    item: Whisper's training (``encdec``) and MoE serving on a model axis
    (22).  Every other family trains on both meshes: deepseek-v2's MLA on
    the model axis, both MoE archs on the pod axis, and rwkv6 and the
    hybrid tensor-parallel."""
    refused = {}
    for multi_pod in (False, True):
        for arch, shape_name in CELLS:
            ok, why = shape_applicable(get_config(arch), SHAPES[shape_name])
            status, reason = D.cell_status(arch, shape_name, multi_pod)
            if not ok:
                assert (status, reason) == ("skip", why)
            elif status == "skip":
                refused[(arch, shape_name, multi_pod)] = reason
    items = {cell: next((f"item {k}" for k in (20, 21, 22, 23, 24)
                         if f"item {k}" in why), "encdec" if "encdec" in why
                        else why) for cell, why in refused.items()}
    want = {("whisper-small", "train_4k"): "encdec",
            ("deepseek-v2-236b", "prefill_32k"): "item 22",
            ("deepseek-v2-236b", "decode_32k"): "item 22",
            ("dbrx-132b", "prefill_32k"): "item 22",
            ("dbrx-132b", "decode_32k"): "item 22"}
    expect = {(a, s, mp): why for (a, s), why in want.items()
              for mp in (False, True)}
    assert items == expect and len(expect) == 10
    assert sum(1 for _ in CELLS) * 2 == 80
    for arch in ("deepseek-v2-236b", "dbrx-132b", "rwkv6-1.6b",
                 "recurrentgemma-9b"):
        for multi_pod in (False, True):
            assert D.cell_status(arch, "train_4k", multi_pod) == ("ok", "")


SMOKE_TRAIN = ShapeSpec("smoke_train", 16, 8, "train")


@pytest.fixture(scope="module")
def smoke_counts():
    """The smoke qwen2-0.5b and dbrx on ``(2, 2)``: the dry run's meta
    count, then one real step of the same cell on the CPU; the caller's
    EP tallies (a sentinel) as the runs leave them."""
    out = {}
    moe_a2a.reset_ep_stats()
    moe_a2a._count("choices", torch.tensor(5))
    for arch in ("qwen2-0.5b", "dbrx-132b"):
        cfg = dataclasses.replace(get_config(arch).smoke(), vocab_size=2048)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        meta = D.measure_cell(cfg, SMOKE_TRAIN, mesh, "cpu")
        gen = torch.Generator()
        gen.manual_seed(0)
        real = D.measure_cell(cfg, SMOKE_TRAIN, mesh, "cpu", generator=gen)
        out[arch] = cfg, mesh, meta, real
    out["ep_stats"] = moe_a2a.ep_stats()
    moe_a2a.reset_ep_stats()
    return out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b"])
def test_the_meta_count_is_a_real_steps(smoke_counts, arch):
    """FlopCounterMode's FLOPs, the collectives' counts and bytes and the
    argument bytes of the meta run equal a real step's on the CPU; the
    real step's loss is finite, and the meta one launched the kernels
    whose work it counted."""
    cfg, mesh, meta, real = smoke_counts[arch]
    assert meta["kind_of_step"] == real["kind_of_step"] == \
        {"qwen2-0.5b": "tensor_parallel", "dbrx-132b": "ep"}[arch]
    assert meta["count"].flops == real["count"].flops > 0
    assert meta["coll"] == real["coll"]
    assert meta["coll"]["count_by_type"]["all-reduce"] > 0
    assert (meta["arg"], meta["out"], meta["alias"]) == \
        (real["arg"], real["out"], real["alias"])
    assert np.isfinite(float(real["count"].out[1]["loss"]))
    # on meta every reduce is a fused_add stand-in, on the CPU its plain
    # version (whose adds FlopCounterMode does not count)
    assert meta["count"].kernel_calls["fused_add"] > 0
    assert real["count"].kernel_calls == {}
    if arch == "dbrx-132b":
        assert meta["coll"]["count_by_type"]["all-to-all"] > 0
        assert meta["alias"] > 0          # the EP step updates in place
        # the runs' own routing tallies (on meta, or a card's where the
        # caller's are the CPU's) never reach the caller's
        assert smoke_counts["ep_stats"] == {"choices": 5}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b"])
def test_the_depth_difference_against_the_full_count(smoke_counts, arch):
    """The depth difference at depths 1 and 2 extrapolates to the
    full-depth count exactly for these uniform stacks: FLOPs, and the
    collective bytes."""
    cfg, mesh, meta, _ = smoke_counts[arch]
    pd = D._depth_diff(cfg, SMOKE_TRAIN, mesh, False, "cpu")
    div = meta["div"]
    assert pd["flops_total"] == meta["count"].flops / div
    assert pd["coll_total"] == meta["coll"]["total_bytes"]


def _ref_smoke_leaves(arch, sizes):
    """The reference's smoke ``arch`` (vocabulary 2048) on a mesh of
    ``sizes``: per parameter leaf, whether it is a routed expert's, its
    bytes a device under ``param_pspecs`` (the model axis splits it), and
    whether ``zero1_spec`` slices its moments over the data axis."""
    from repro.models import get_model as R_get_model
    from repro.parallel.sharding import param_pspecs, zero1_spec

    rcfg = dataclasses.replace(R_get_config(arch).smoke(), vocab_size=2048)
    params = jax.eval_shape(
        lambda: R_get_model(rcfg).init(jax.random.PRNGKey(0)))
    mesh = SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.empty(tuple(sizes.values()), object))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    specs = jax.tree.leaves(param_pspecs(params, rcfg, mesh), is_leaf=is_spec)
    out = []
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(params)[0], specs):
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        for part in spec:
            for axis in (part if isinstance(part, tuple) else (part,)):
                if axis is not None:
                    n //= sizes[axis]
        expert = "moe" in keys and "shared" not in keys and \
            keys[-1] in ("w1", "w3", "w2")
        sliced = zero1_spec(spec, tuple(leaf.shape), mesh) != spec
        out.append((expert, n, sliced))
    return out


def test_the_collectives_one_rank_sends_by_hand(smoke_counts):
    """One rank's collectives on ``(2, 2)``, counted by hand from the
    reference's specs.  The tensor-parallel qwen2-0.5b: against the same
    step on ``(1, 2)`` at the same rows a data group, the data axis adds
    one all-reduce of a rank's gradients (its model shard of each leaf)
    and one ZeRO-1 all-gather of its shard of the sliced leaves, and the
    model axis's traffic is the same (each data group's runs are a rank's
    once); every model-axis all-reduce there is one rank's ``[rows, S,
    d]`` f32 result, but the loss's ``[rows, S]`` and the clip's scalar.
    The EP dbrx: per MoE layer, the tokens' dispatch and return and the
    expert ids' dispatch, in the forward and the block's recompute, and
    the two token all-to-alls' backward, each carrying one rank's ``n x
    C`` pieces of its sequence column.  The EP dbrx on ``(2, 2, 2)``, at
    the same rows a data-parallel rank: besides what ``(2, 2)`` sends,
    one pod-axis all-reduce of a rank's experts (its ``E/D`` of each
    expert leaf, its model shard) and one pod-axis all-gather a leaf whose
    moments ``zero1_spec`` slices over the pods (the calls that cover
    every rank at once, the model axis's and the all-to-alls' apart)."""
    B, S = SMOKE_TRAIN.global_batch, SMOKE_TRAIN.seq_len
    sizes = {"data": 2, "model": 2}
    rows = B // sizes["data"]

    cfg, _, meta, _ = smoke_counts["qwen2-0.5b"]
    leaves = _ref_smoke_leaves("qwen2-0.5b", sizes)
    grads = sum(n for _, n, _ in leaves)
    zero = sum(n for _, n, sliced in leaves if sliced)
    one = D.measure_cell(cfg, ShapeSpec("smoke_dp1", S, rows, "train"),
                         make_mesh((1, 2), ("data", "model"), "cpu"),
                         "cpu")["coll"]
    got = meta["coll"]
    count, nbytes = got["count_by_type"], got["bytes_by_type"]
    c1, b1 = one["count_by_type"], one["bytes_by_type"]
    assert zero > 0 and (count["all-reduce"], nbytes["all-reduce"]) == \
        (c1["all-reduce"] + 1, b1["all-reduce"] + grads)
    assert (count["all-gather"], nbytes["all-gather"]) == \
        (c1["all-gather"] + 1, b1["all-gather"] + zero)
    hidden = rows * S * cfg.d_model * 4
    assert b1["all-reduce"] == (c1["all-reduce"] - 2) * hidden + \
        rows * S * 4 + 4

    cfg, _, meta, _ = smoke_counts["dbrx-132b"]
    n, cols, K = sizes["data"], sizes["model"], cfg.moe_top_k
    C = max(int(np.ceil(rows * S // cols * K / n * cfg.capacity_factor)), K)
    tokens, ids = n * C * cfg.d_model * 4, n * C * 8
    L = cfg.n_layers - cfg.n_dense_layers
    got = meta["coll"]
    assert (got["count_by_type"]["all-to-all"],
            got["bytes_by_type"]["all-to-all"]) == \
        (8 * L, L * (6 * tokens + 2 * ids))

    # the calls that cover every rank at once (groups 1: the data axes'
    # and the pod axis's), kept apart from the model axis's and the
    # all-to-alls', which a rank of each data-parallel group makes
    calls = {}
    pod_sizes = {"pod": 2, "data": 2, "model": 2}
    for name, sz, rows in (("flat", sizes, B), ("pods", pod_sizes, 2 * B)):
        with KernelWork() as kw:
            D.measure_cell(cfg, ShapeSpec(name, S, rows, "train"),
                           make_mesh(tuple(sz.values()), tuple(sz), "cpu"),
                           "cpu")
        calls[name] = {k: v for (k, groups), v in kw._coll.items()
                       if groups == 1}
    flat = _ref_smoke_leaves("dbrx-132b", sizes)
    leaves = _ref_smoke_leaves("dbrx-132b", pod_sizes)
    experts = sum(n for e, n, _ in leaves if e)
    pod_sliced = [n for e, n, sliced in leaves if e and sliced]
    zero = [n for e, n, sliced in leaves if sliced and not e]
    zero_flat = [n for _, n, sliced in flat if sliced]
    assert len(pod_sliced) == 3 and experts > 0
    got, want = calls["pods"], calls["flat"]
    assert got["all-reduce"] == [want["all-reduce"][0] + 1,
                                 want["all-reduce"][1] + experts]
    assert want["all-gather"] == [len(zero_flat), sum(zero_flat)]
    assert got["all-gather"] == [len(zero) + len(pod_sliced),
                                 sum(zero) + sum(pod_sliced)]


def test_the_count_against_xlas_cost_analysis(R_dry):
    """The smoke qwen2-0.5b ``tiny_train`` cell on a 1x1 mesh (the setup
    of ``tests/test_system.py``) at ``_depth_variant``: XLA's flops count
    the matmuls the port counts and the elementwise operations it does
    not, so they lie above the port's count by less than the bound; the
    count without the LM head (its forward and two backward products)
    falls outside it."""
    from repro.launch.mesh import make_mesh_for_tests
    from repro.launch.specs import input_specs, step_callable

    shape_t = ShapeSpec("tiny_train", 16, 4, "train")
    rcfg = R_dry._depth_variant(R_get_config("qwen2-0.5b").smoke(), 1)
    from repro.configs.base import ShapeSpec as R_ShapeSpec
    rshape = R_ShapeSpec("tiny_train", 16, 4, "train")
    rmesh = make_mesh_for_tests((1, 1), ("data", "model"))
    with jax.set_mesh(rmesh):
        compiled = jax.jit(step_callable(rcfg, rshape)).lower(
            *input_specs(rcfg, rshape, rmesh)).compile()
    xla = float(compiled.cost_analysis()["flops"])

    cfg = D._depth_variant(get_config("qwen2-0.5b").smoke(), 1)
    got = D.measure_cell(cfg, shape_t, make_mesh((1, 1), ("data", "model"),
                                                 "cpu"), "cpu")
    assert got["kind_of_step"] == "one_rank"
    port = got["count"].flops
    tokens = shape_t.global_batch * shape_t.seq_len
    head = 3 * 2 * tokens * cfg.d_model * cfg.vocab_size
    ratio = xla / port
    assert 1.0 <= ratio < XLA_BOUND, ratio
    assert xla / (port - head) >= XLA_BOUND


#: XLA's flops over the port's count on the smoke cell above (measured
#: 1.083; without the LM head 1.444): the elementwise share XLA counts and
#: FlopCounterMode does not (PERF.md)
XLA_BOUND = 1.15


def test_the_command_in_process(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape
    train_4k --no-diff`` through ``main``, on the CPU, at one layer with
    the attention and loss unchunked (the full cell is the card host's):
    one JSON with the reference's keys and the departures."""
    override = json.dumps({"n_layers": 1, "attn_q_chunk": 0,
                           "loss_chunk_size": 0})
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "qwen2-0.5b", "--shape", "train_4k", "--no-diff",
        "--out", str(tmp_path), "--override", override, "--device", "cpu"])
    with pytest.raises(SystemExit) as done:
        D.main()
    assert done.value.code == 0
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["qwen2-0.5b_train_4k_sp_opt.json"]
    rec = json.loads(files[0].read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    for key in ("arch", "shape", "mesh", "kind", "n_chips", "memory",
                "cost_analysis_raw", "collectives", "roofline", "trace_s"):
        assert key in rec, key
    assert "lower_s" not in rec and "per_device" not in rec
    mem = rec["memory"]
    for key in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                "code_bytes", "live_bytes_per_device", "fits_hbm"):
        assert key in mem, key
    assert "fits_16GB" not in mem and mem["code_bytes"] == 0
    assert rec["roofline"]["source"] == "scan_raw"
    assert set(rec["collectives"]["bytes_by_type"]) == {"all-reduce",
                                                       "all-gather"}
    assert "[dryrun] done; 0 failures" in capsys.readouterr().out


def test_the_kernels_stand_in_on_meta():
    """Each kernel's wrapper on meta tensors launches nothing, returns its
    kernel's output shapes and reports its ``work()`` to an open
    ``KernelWork``; the schedule runner runs its one path on meta, one
    accumulate a reduce step, to the result shape of a real run, and its
    link gathers count no bytes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ring_collective as rc
    from repro_torch.kernels import rwkv6_chunked as wc
    from repro_torch.kernels import rwkv6_scan as ws
    from repro_torch.kernels.accounting import KernelWork
    from repro_torch.kernels.schedule_runner import (
        device_tables, issue_round, run_schedule, schedule_tables, seed_state)
    from repro_torch.train import certified_allreduce

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    launched = (fa.flash_attention.launches, rc.fused_add.launches,
                rc.remote_ring_reduce_scatter.launches,
                wc.wkv_chunked_matmul.launches, ws.wkv_scan.launches)
    B, S, H, K = 1, 32, 2, 16
    rkw = [meta(B, S, H, K) for _ in range(3)]
    u = meta(H, K, dtype=torch.float32)
    with KernelWork() as kw:
        out = fa.flash_attention(meta(2, 4, 64, 64), meta(2, 2, 64, 64),
                                 meta(2, 2, 64, 64), causal=True, window=16)
        a = meta(1000)
        assert rc.fused_add(a, meta(1000), out=a) is a
        ring = rc.remote_ring_reduce_scatter(meta(4, 64))
        y, state = wc.wkv_chunked_matmul(rkw[0], rkw[1], meta(B, S, H, K),
                                         rkw[2], u, chunk=16)
        y2 = ws.wkv_scan(rkw[0], rkw[1], meta(B, S, H, K), rkw[2], u)
    assert (tuple(out.shape), tuple(ring.shape), tuple(y.shape),
            tuple(state.shape), state.dtype, tuple(y2.shape)) == (
        (2, 4, 64, 64), (4, 16), (B, S, H, K), (B, H, K, K), torch.float32,
        (B, S, H, K))
    assert kw.calls == dict.fromkeys(
        ("flash_attention", "fused_add", "peer_ring", "wkv_chunked",
         "wkv_scan"), 1)
    flash = fa.work(2, 4, 2, 64, 64, True, 16, 2)
    chunked = wc.work(B, S, H, K, K, 16, 2)
    scan = ws.work(B, S, H, K, K, 2)
    assert kw.flops == flash[0] + chunked[1] + scan[1]
    assert kw.bytes == (flash[1] + rc.work(1000, 2) + rc.ring_work(4, 64, 2)[1]
                        + chunked[0] + scan[0])
    assert launched == (fa.flash_attention.launches, rc.fused_add.launches,
                        rc.remote_ring_reduce_scatter.launches,
                        wc.wkv_chunked_matmul.launches, ws.wkv_scan.launches)

    sched = certified_allreduce(4, 4.0, "ring")
    tables, ops = schedule_tables(sched)
    reduces = sum(bool(eff) and op == "reduce"
                  for rt, ro in zip(tables, ops)
                  for (eff, _s, _r), op in zip(rt, ro))
    with KernelWork() as kw:
        got = run_schedule(meta(4, 64, dtype=torch.float32), sched)
    real = run_schedule(torch.zeros(4, 64), sched)
    assert tuple(got.shape) == tuple(real.shape)
    assert kw.calls == {"fused_add": reduces} and reduces == 3
    state = seed_state(sched, meta(4, 64, dtype=torch.float32))
    with D.MetaCounter() as mc:
        staged = issue_round(state, device_tables(sched, state.device)[0],
                             slice(None))
    assert staged and mc.bytes == 0


def test_serve_refuses_moe_on_a_model_axis_in_words():
    """``serve`` of an MoE arch on a mesh with a data and a model axis
    raised deep in ``moe_ranks`` (its replicated forward gives the EP
    layer no model axis); it now refuses in words naming item 22, which
    the dry run reports as the cell's reason.  On a data axis alone it
    still arms EP."""
    from repro_torch import cli
    from repro_torch.launch.serve import serve_layout

    with pytest.raises(NotImplementedError, match="item 22"):
        cli.main(["serve", "--arch", "dbrx-132b", "--smoke", "--device", "cpu",
                  "--mesh", "2x2", "--reorder", "none", "--batch", "2",
                  "--prompt-len", "8", "--max-new", "1"])
    assert moe_a2a._EP_STATE["mesh"] is None
    assert serve_layout(get_config("dbrx-132b"), (4,), ("data",)) == \
        {"ep_armed": True, "model_axis": 1}
    assert serve_layout(get_config("glm4-9b"), (2, 2), ("data", "model")) == \
        {"ep_armed": False, "model_axis": 2}
