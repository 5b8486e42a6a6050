"""The peer-memory ring reduce-scatter and the planned training step.

On the CPU the wrapper runs its plain version: held to JAX's
``ring_reduce_scatter_ref`` and, bit for bit, to the port's
``ring_reduce_scatter``.  The smoke f32 qwen2-0.5b step through
``reducer_from_plan(..., transport="peer_ring")`` is held to JAX's
one-device baseline step.  The kernel itself runs only on the card.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data import host_batch as jax_host_batch  # noqa: E402
from repro.kernels.ref import ring_reduce_scatter_ref as jax_rs_ref  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fabric import make_datacenter, probe_fabric, scramble  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ring_collective as rc  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt  # noqa: E402
from repro_torch.plan import PlanCompiler  # noqa: E402
from repro_torch.session import train_mix  # noqa: E402
from repro_torch.train import (  # noqa: E402
    OverlapGradReducer,
    TrainState,
    certified_allreduce,
    make_overlap_train_step,
    reducer_from_plan,
)
from repro_torch.tree import tree_leaves  # noqa: E402

#: the planned order of chip_smoke.py's configuration
PLAN_PERM = [0, 7, 3, 5, 2, 4, 1, 6]
PAYLOAD = 988_065_536


def _perms(n):
    rng = np.random.default_rng(n)
    out = [list(range(n)), list(range(n))[::-1],
           [int(p) for p in rng.permutation(n)]]
    if n == 8:
        out.append(PLAN_PERM)
    return out


def _x(n, width, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, n * width)).astype(np.float32))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_plain_ring_equals_the_reference_and_the_virtual_ring(n):
    """f32 against JAX's oracle within n ulps of the sum; f32 and bf16 bit
    for bit against ``ring_reduce_scatter`` (gather + add, the same
    additions in the same order)."""
    x = _x(n, 7, seed=n)                       # L = n x an odd length
    want = np.asarray(jax_rs_ref(x.numpy(), n))
    for perm in _perms(n):
        got = rc.remote_ring_reduce_scatter(x, perm)
        assert got.shape == (n, 7)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * n * float(x.abs().max()))
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            assert torch.equal(rc.remote_ring_reduce_scatter(xd, perm),
                               rc.ring_reduce_scatter(xd, perm,
                                                      use_kernel_add=False))
            assert torch.equal(rc.remote_ring_reduce_scatter_plain(xd, perm),
                               rc.ring_reduce_scatter(xd, perm))


def test_schedule_constants_match_the_kernel():
    """The plain schedule's tile, slots and FIFO budget are the kernel's."""
    src = (build.CSRC / "peer_ring.cu").read_text()
    assert f"constexpr int kTileBytes = {rc.RING_TILE_BYTES};" in src
    assert f"constexpr int kSlots = {rc.RING_SLOTS};" in src
    assert f"constexpr long long kFifoBudget = {rc.RING_FIFO_BUDGET >> 20}ll << 20;" in src


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_schedule_plain_equals_the_ring_and_the_reference(n):
    """The kernel's own schedule at a tile of 8 bytes (so several blocks
    and tiles at these widths), at odd chunk lengths and every order: f32
    within n ulps of JAX's oracle, f32 and bf16 bit for bit to
    ``ring_reduce_scatter``."""
    state = rc.RingState(n, max_blocks=3)
    for width in (7, 37):
        x = _x(n, width, seed=n + width)
        want = np.asarray(jax_rs_ref(x.numpy(), n))
        for k, perm in enumerate(_perms(n)):
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                got = rc.peer_ring_schedule_plain(xd, perm, state=state,
                                                  tile_bytes=8, seed=k)
                assert torch.equal(got, rc.ring_reduce_scatter(xd, perm))
                if dt == torch.float32:
                    np.testing.assert_allclose(
                        got.numpy(), want, rtol=0,
                        atol=1e-5 * n * float(x.abs().max()))
    assert any(r["blocks"] > 1 and max(r["tiles"]) > 1 for r in state.log)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_schedule_plain_keeps_the_protocol_over_launches_of_other_shapes(n):
    """Ten launches on one card's state, each of another L (so another
    block count and other tiles a block), order, dtype and interleaving of
    the blocks: each exact; at each launch's start all ranks' counters of
    a slice are equal; no FIFO slot is overwritten before its consumer
    has read it, and no read finds another write than the one it waited
    for; each launch advances both counters of slice j by tiles_j (n-2)."""
    state = rc.RingState(n, max_blocks=4)
    rng = np.random.default_rng(100 + n)
    for launch in range(10):
        width = int(rng.choice([1, 3, 8, 13, 40, 64]))
        perm = [int(p) for p in rng.permutation(n)]
        dt = (torch.float32, torch.bfloat16)[launch % 2]
        x = torch.from_numpy(rng.standard_normal((n, n * width))
                             .astype(np.float32)).to(dt)
        got = rc.peer_ring_schedule_plain(x, perm, state=state, tile_bytes=16,
                                          seed=launch)
        assert torch.equal(got, rc.ring_reduce_scatter(x, perm))
        rec = state.log[-1]
        assert rec["equal_at_start"]
        assert rec["overwrites_unread"] == 0 and rec["bad_reads"] == 0
        for j, tiles in enumerate(rec["tiles"]):
            assert (rec["advance"][:, :, j] == tiles * (n - 2)).all()
    assert len({r["blocks"] for r in state.log}) > 1
    assert len({tuple(r["tiles"]) for r in state.log}) > 2


def test_ring_work_counts_the_bytes():
    # the path's largest call: [8, 136134656] bf16
    ring, fn = rc.ring_work(8, 136_134_656, 2)
    assert ring == 3 * 7 * 136_134_656 * 2 == 5_717_655_552
    assert fn == 9 * 136_134_656 * 2


def test_wrapper_refusals():
    x = _x(4, 3, seed=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rc.remote_ring_reduce_scatter(x.half())
    with pytest.raises(ValueError, match="multiple of n=4"):
        rc.remote_ring_reduce_scatter(x[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rc.remote_ring_reduce_scatter(x.t().contiguous().t())
    with pytest.raises(ValueError, match="permutation"):
        rc.remote_ring_reduce_scatter(x, [0, 1, 1, 3])
    with pytest.raises(ValueError, match="2 to 32 ranks"):
        rc.remote_ring_reduce_scatter(x[:1])
    with pytest.raises(ValueError, match=r"\[n, L\]"):
        rc.remote_ring_reduce_scatter(x.reshape(-1))


def test_peer_ring_transport_refuses_a_non_ring_schedule():
    hd = certified_allreduce(8, 1e6, algo="halving_doubling")
    with pytest.raises(ValueError, match="ring schedule only"):
        OverlapGradReducer(hd, transport="peer_ring")
    OverlapGradReducer(hd, transport="runner")
    with pytest.raises(ValueError, match="transport must be one of"):
        OverlapGradReducer(certified_allreduce(8, 1e6), transport="nccl")


def test_peer_ring_reducer_equals_the_runner():
    """Every bucket through the ring at the schedule's order: the mean
    equals the runner's to f32 summation order, with the same buckets."""
    sched = certified_allreduce(8, 4096.0, algo="ring", perm=PLAN_PERM)
    rng = np.random.default_rng(1)
    tree = {"a": torch.from_numpy(rng.standard_normal((8, 3, 50)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((8, 700)).astype(np.float32))}
    want = tree_leaves({k: v.mean(0) for k, v in tree.items()})
    for mode in ("sequential", "bucketed", "fused"):
        ring = OverlapGradReducer(sched, bucket_bytes=400.0, mode=mode,
                                  transport="peer_ring")
        runner = OverlapGradReducer(sched, bucket_bytes=400.0, mode=mode)
        assert len(ring.buckets_for(tree)) > 1
        got, _ = ring(tree, compute=[lambda: 7])
        ref, _ = runner(tree)
        for g, r, w in zip(tree_leaves(got), tree_leaves(ref), want):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    """The smoke qwen2-0.5b in f32 from JAX's init, JAX's one-device
    baseline step, and the plan of chip_smoke.py's configuration."""
    jcfg = jax_get_config("qwen2-0.5b").smoke()
    jm = jax_get_model(jcfg)
    jstate = jax_init_state(jm, jax.random.PRNGKey(0))
    jbatch = jax_host_batch(JaxSyntheticLM(jcfg.vocab_size, 16, 8, seed=0), 0)
    base_state, base_metrics = jax.jit(jax_make_train_step(
        jm, JaxAdamWConfig(lr=1e-3)))(jstate, jbatch)
    model = get_model(get_config("qwen2-0.5b").smoke(), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), model)
    fab, _ = scramble(make_datacenter(8, nodes_per_rack=4, racks_per_agg=2,
                                      seed=0), seed=1)
    plan = PlanCompiler(fabric=fab, seed=0).compile(
        probe_fabric(fab, seed=0), train_mix(PAYLOAD), mesh_shape=(8,))
    return dict(jbatch=jbatch, base_state=base_state, base_metrics=base_metrics,
                model=model, params=params, plan=plan)


@pytest.mark.parametrize("mode,split", [("bucketed", False), ("fused", True),
                                        ("sequential", True)])
def test_planned_step_matches_the_reference_baseline(setup, mode, split):
    """PR 12's tolerances: loss rtol 2e-5, grad norm rtol 2e-4, params
    atol 1e-4.  The plan is the one compiled for the full-width payload,
    so the lookup reaches the planned ring even for the smoke tree;
    ``split`` cuts the tree into several buckets."""
    model, params = setup["model"], setup["params"]
    pb = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    red = reducer_from_plan(setup["plan"], PAYLOAD, mode=mode,
                            bucket_bytes=pb / 3.5 if split else None)
    assert red.transport == "peer_ring"
    assert list(red.schedule.order) == PLAN_PERM
    state = TrainState(params, init_opt(params), torch.zeros((), dtype=torch.int32))
    new_state, metrics = make_overlap_train_step(
        model, AdamWConfig(lr=1e-3), red)(state, setup["jbatch"])
    base = setup["base_metrics"]
    np.testing.assert_allclose(float(metrics["loss"]), float(base["loss"]),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(base["grad_norm"]), rtol=2e-4, atol=1e-5)
    got_l = tree_leaves(new_state.params)
    want_l = jax.tree.leaves(setup["base_state"].params)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   rtol=0, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the peer ring kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_peer_ring_equals_the_virtual_ring(cuda_device, n, dtype):
    dt = getattr(torch, dtype)
    for width in (7, 8 * 1031):
        x = _x(n, width, seed=n).to(cuda_device, dt)
        for perm in _perms(n):
            before = rc.remote_ring_reduce_scatter.launches
            got = rc.remote_ring_reduce_scatter(x, perm)
            torch.cuda.synchronize()
            assert rc.remote_ring_reduce_scatter.launches == before + 1
            assert rc.ring_status(cuda_device) == 0
            assert torch.equal(got, rc.ring_reduce_scatter(x, perm))
            assert torch.equal(got, rc.remote_ring_reduce_scatter_plain(x, perm))


def test_peer_ring_reducer_rings_a_plan_that_is_not_a_ring():
    """Over 3 ranks the plan's all-reduce is a double binary tree: the
    runner transport runs it as planned, the ring kernel's transport runs
    a certified ring at the planned order (``train --mesh 3`` on the card
    once raised here)."""
    from repro_torch.session import Session, SessionConfig

    # what `train --mesh 3 --reorder simulate` plans
    with Session(SessionConfig().replace(
            fabric={"kind": "tpu-fleet", "pod_shape": (3, 1),
                    "scramble_seed": 0},
            mesh={"shape": (3,), "axis_names": ("data",)},
            payload_bytes=8.98e9, moe=True)) as s:
        plan = s.plan()
    runner = reducer_from_plan(plan, 8.98e9, transport="runner")
    assert runner.schedule.algorithm == "double_binary_tree"
    ring = reducer_from_plan(plan, 8.98e9)
    entry = plan.lookup("all-reduce", ring.bucket_bytes)
    assert (ring.schedule.algorithm, ring.transport) == ("ring", "peer_ring")
    assert list(ring.schedule.order) == [entry.group.index(p)
                                         for p in entry.perm]
    assert ring.bucket_bytes == runner.bucket_bytes
    x = torch.randn(3, 6, generator=torch.Generator().manual_seed(0))
    got, _ = ring({"g": x})
    torch.testing.assert_close(got["g"], x.mean(0), rtol=1e-6, atol=1e-6)
