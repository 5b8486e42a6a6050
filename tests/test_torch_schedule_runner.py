"""The port's virtual-mesh runners and fused_add against the JAX package's."""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.collective import CollectiveOp as RefOp  # noqa: E402
from repro.collective import JaxExecutor  # noqa: E402
from repro.collective import compile_op as ref_compile  # noqa: E402
from repro.collective import get_builder as ref_get_builder  # noqa: E402
from repro.collective import registered_builders as ref_registered  # noqa: E402
from repro.collective.builders import candidates as ref_candidates  # noqa: E402
from repro.collective.passes import apply_permutation as ref_permute  # noqa: E402
from repro.collective.passes import chunk as ref_chunk  # noqa: E402
from repro.kernels import schedule_runner as ref_runner  # noqa: E402
from repro.kernels.ref import ring_reduce_scatter_ref as jax_rs_ref  # noqa: E402
from repro.kernels.ring_collective import fused_add as jax_fused_add  # noqa: E402
from repro_torch.analysis import require_certified  # noqa: E402
from repro_torch.collective import (  # noqa: E402
    CollectiveOp,
    ScheduleLowering,
    apply_permutation,
    chunk,
    compile_op,
)
from repro_torch.kernels import ring_collective as rc  # noqa: E402
from repro_torch.kernels import schedule_runner  # noqa: E402
from repro_torch.kernels.overlap import (  # noqa: E402
    build_overlap_plan,
    finish_state,
    run_overlapped,
    seed_state,
)
from repro_torch.kernels.ref import ring_reduce_scatter_ref  # noqa: E402
from repro_torch.kernels.schedule_runner import run_schedule  # noqa: E402
from repro_torch.train.overlap_grads import certified_allreduce  # noqa: E402

RING_PERM = [0, 3, 1, 7, 2, 6, 4, 5]


def _matrix(n_list=(4, 8)):
    """test_lowering_equiv.py's cases, less ring_sequential: it is
    certified, but its second lap double-counts, so the reference runs it
    on no numbers either."""
    cases = []
    for algo in sorted(ref_registered()):
        if algo == "ring_sequential":
            continue
        for kind in ref_get_builder(algo).kinds:
            for n in n_list:
                for a, akw in ref_candidates(kind, n):
                    if a == algo:
                        cases.append((algo, kind, n, tuple(sorted(akw.items()))))
    return cases


MATRIX = _matrix()
IDS = [f"{a}-{k}-n{n}" for a, k, n, _ in MATRIX]


def _certified(algo, kind, n, akw, variant, size=1 << 12):
    """The same certified schedule from the reference and from the port."""
    ref = ref_compile(RefOp(kind=kind, size_bytes=size, group=tuple(range(n))),
                      algo, **dict(akw))
    port = compile_op(CollectiveOp(kind=kind, size_bytes=size,
                                   group=tuple(range(n))), algo, **dict(akw))
    if variant == "permuted":
        perm = list(range(n))
        random.Random(n).shuffle(perm)
        ref, port = ref_permute(ref, perm), apply_permutation(port, perm)
    elif variant == "chunked":
        ref, port = ref_chunk(ref, 2), chunk(port, 2)
    sched = ScheduleLowering().lower_schedule(port)
    require_certified(port, sched)
    return JaxExecutor().lower_schedule(ref), sched


def _inputs(sched, per_chunk=8, seed=0):
    """Rank-major [n, D] inputs shaped by the schedule's init."""
    n = sched.n
    width = {"replicated": sched.n_chunks, "sharded": 1,
             "addressed": n}[sched.init] * per_chunk
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, width)).astype(np.float32)


@pytest.mark.parametrize("variant", ["identity", "permuted", "chunked"])
@pytest.mark.parametrize("algo,kind,n,akw", MATRIX, ids=IDS)
def test_run_schedule_meets_the_reference_postcondition(algo, kind, n, akw,
                                                        variant):
    ref_sched, sched = _certified(algo, kind, n, akw, variant)
    ref_tables, ref_ops = ref_runner.schedule_tables(ref_sched)
    tables, ops = schedule_runner.schedule_tables(sched)
    assert ops == ref_ops
    for rt, pt in zip(ref_tables, tables):
        for (r_links, r_send, r_recv), (p_links, p_send, p_recv) in zip(rt, pt):
            assert p_links == r_links
            np.testing.assert_array_equal(p_send, r_send)
            np.testing.assert_array_equal(p_recv, r_recv)
    x = _inputs(sched)
    out = run_schedule(torch.from_numpy(x), sched)
    assert ref_runner.check_postcondition(ref_sched, x, out.numpy()) == []
    assert schedule_runner.check_postcondition(sched, x, out) == []


OVERLAP_CASES = [("ring", 2, ()), ("halving_doubling", 1, ()),
                 ("double_binary_tree", 1, ()), ("bcube", 1, (("base", 2),))]


@pytest.mark.parametrize("algo,k,akw", OVERLAP_CASES,
                         ids=[c[0] for c in OVERLAP_CASES])
def test_run_overlapped_equals_run_schedule_bitwise(algo, k, akw):
    """tests/test_overlap.py's 8-rank check, on the virtual mesh."""
    n = 8
    prog = apply_permutation(
        compile_op(CollectiveOp("allreduce", 1 << 12, tuple(range(n))), algo,
                   **dict(akw)), [3, 1, 4, 7, 5, 0, 2, 6])
    if k > 1:
        prog = chunk(prog, k)
    sched = ScheduleLowering().lower_schedule(prog)
    require_certified(prog, sched)
    d = (1 << 12) // 4
    x = torch.arange(n * d, dtype=torch.float32).reshape(n, d) / (n * d)
    ref = run_schedule(x, sched, use_kernel_add=False)
    out, _ = run_overlapped(x, sched, use_kernel_add=False)
    assert torch.equal(ref, out)
    assert torch.equal(ref, run_schedule(x, sched))       # kernel path == +
    comp = [lambda i=i: torch.sum(torch.ones((16, 16)) * i) for i in range(5)]
    out2, res = run_overlapped(x, build_overlap_plan(sched, 5), compute=comp)
    assert torch.equal(ref, out2)
    assert [float(r) for r in res] == [256.0 * i for i in range(5)]
    m = max(1, len(sched.rounds) // 2)
    st = seed_state(sched, x)
    st, _ = run_overlapped(None, sched, state=st, rounds=(0, m), return_state=True)
    st, _ = run_overlapped(None, sched, state=st, rounds=(m, None),
                           return_state=True)
    assert torch.equal(ref, finish_state(sched, st))
    # the bf16 payload too: the kernel path rounds once per add, like +
    xb = x.to(torch.bfloat16) * 3
    assert torch.equal(run_schedule(xb, sched),
                       run_schedule(xb, sched, use_kernel_add=False))


def test_schedule_tables_no_rebuild(monkeypatch):
    """Tables are built once per schedule value, never per call."""
    sched = certified_allreduce(4, 1 << 12, algo="ring")
    calls = {"n": 0}
    real = schedule_runner._step_tables

    def counting(step, n, n_chunks):
        calls["n"] += 1
        return real(step, n, n_chunks)

    monkeypatch.setattr(schedule_runner, "_step_tables", counting)
    schedule_runner.schedule_tables.cache_clear()
    t1 = schedule_runner.schedule_tables(sched)
    n_steps = sum(len(r) for r in sched.rounds)
    assert calls["n"] == n_steps
    assert schedule_runner.schedule_tables(sched) is t1
    schedule_runner.schedule_tables(certified_allreduce(4, 1 << 12, algo="ring"))
    assert calls["n"] == n_steps
    schedule_runner.schedule_tables.cache_clear()


@pytest.mark.parametrize("perm", [None, RING_PERM], ids=["identity", "reordered"])
def test_ring_matches_the_reference_oracle(perm):
    """tests/test_system.py:134-141 on the virtual mesh."""
    x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    want = np.asarray(jax_rs_ref(jnp.asarray(x), 8))
    out = rc.ring_reduce_scatter(torch.from_numpy(x), perm=perm)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(ring_reduce_scatter_ref(torch.from_numpy(x), 8).numpy(),
                               want, atol=1e-5)
    full = rc.ring_all_reduce(torch.from_numpy(x), perm=perm)
    np.testing.assert_allclose(full.numpy(), np.tile(x.sum(0), (8, 1)), atol=1e-4)
    plain = rc.ring_reduce_scatter(torch.from_numpy(x), perm=perm,
                                   use_kernel_add=False)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("n,block", [(64, 16), (100, 32), (1024, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_plain_equals_the_reference_kernel(n, block, dtype):
    """The plain version == the Pallas kernel in interpret mode, bit for bit."""
    rng = np.random.default_rng(n)
    a32 = rng.standard_normal(n).astype(np.float32)
    b32 = rng.standard_normal(n).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = jax_fused_add(jnp.asarray(a32, jdt), jnp.asarray(b32, jdt),
                         block=block, interpret=True)
    tdt = getattr(torch, dtype)
    a, b = torch.from_numpy(a32).to(tdt), torch.from_numpy(b32).to(tdt)
    got = rc.fused_add_plain(a, b)
    want_t = torch.from_numpy(np.array(want, np.float32)).to(tdt)
    assert torch.equal(got, want_t)
    # the wrapper on CPU tensors is the plain version, in and out of place
    assert torch.equal(rc.fused_add(a, b), got)
    acc = a.clone()
    assert rc.fused_add(acc, b, out=acc) is acc and torch.equal(acc, got)
    assert torch.equal(a + b, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_at_element_offsets_equals_the_reference_kernel(dtype):
    """Views at element offsets 0-7 into their buffers, the same and
    different for a, b and out (the runner passes such views; the kernel
    peels a scalar head up to 16 bytes or runs in scalars), in and out of
    place: equal to JAX's Pallas kernel in interpret mode."""
    n = 45
    rng = np.random.default_rng(7)
    a32 = rng.standard_normal(n + 8).astype(np.float32)
    b32 = rng.standard_normal(n + 8).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    abuf, bbuf = torch.from_numpy(a32).to(tdt), torch.from_numpy(b32).to(tdt)
    offsets = [(o, o, o) for o in range(8)] + [(0, 1, 2), (3, 0, 7), (5, 6, 0)]
    for oa, ob, oo in offsets:
        want = jax_fused_add(jnp.asarray(a32[oa:oa + n], jdt),
                             jnp.asarray(b32[ob:ob + n], jdt), block=16,
                             interpret=True)
        want_t = torch.from_numpy(np.array(want, np.float32)).to(tdt)
        a, b = abuf[oa:oa + n], bbuf[ob:ob + n]
        out = torch.zeros(n + 8, dtype=tdt)[oo:oo + n]
        assert rc.fused_add(a, b, out=out) is out and torch.equal(out, want_t)
        acc = abuf.clone()[oa:oa + n]
        assert torch.equal(rc.fused_add(acc, b, out=acc), want_t)


def test_fused_add_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="equal shapes"):
        rc.fused_add(torch.zeros(4), torch.zeros(5))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 100, 1024, (1 << 20) + 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_add_matches_plain(cuda_device, n, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n)
    dt = getattr(torch, dtype)
    a = torch.randn(n, generator=gen, device=cuda_device).to(dt)
    b = torch.randn(n, generator=gen, device=cuda_device).to(dt)
    want = rc.fused_add_plain(a, b)
    before = rc.fused_add.launches
    got = rc.fused_add(a, b)
    acc = a.clone()
    rc.fused_add(acc, b, out=acc)
    torch.cuda.synchronize()
    assert rc.fused_add.launches == before + 2
    assert torch.equal(got, want) and torch.equal(acc, want)
    # misaligned views take the scalar path
    got_tail = rc.fused_add(a[1:].contiguous(), b[1:].contiguous())
    assert torch.equal(got_tail, want[1:])
