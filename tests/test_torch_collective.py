"""The port's collective IR, lowering and certifier against the JAX package's."""

import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.analysis import require_certified as ref_require_certified  # noqa: E402
from repro.collective import CollectiveOp as RefOp  # noqa: E402
from repro.collective import JaxExecutor  # noqa: E402
from repro.collective import compile_op as ref_compile  # noqa: E402
from repro.collective import get_builder as ref_get_builder  # noqa: E402
from repro.collective import registered_builders as ref_registered  # noqa: E402
from repro.collective.builders import candidates as ref_candidates  # noqa: E402
from repro.collective.passes import apply_permutation as ref_permute  # noqa: E402
from repro.collective.passes import chunk as ref_chunk  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    VerificationError,
    bisimulate,
    require_certified,
    symbolic_execute,
)
from repro_torch.collective import (  # noqa: E402
    CollectiveOp,
    ScheduleLowering,
    apply_permutation,
    candidates,
    chunk,
    compile_op,
    fuse_rounds,
    registered_builders,
    validate,
)


def _matrix(n_list=(4, 8)):
    """The (algorithm, kind, n, kwargs) cases of test_lowering_equiv.py."""
    cases = []
    for algo in sorted(ref_registered()):
        for kind in ref_get_builder(algo).kinds:
            for n in n_list:
                for a, akw in ref_candidates(kind, n):
                    if a == algo:
                        cases.append((algo, kind, n, tuple(sorted(akw.items()))))
    return cases


MATRIX = _matrix()
VARIANTS = ["identity", "permuted", "chunked"]
IDS = [f"{a}-{k}-n{n}" for a, k, n, _ in MATRIX]


def _both(algo, kind, n, akw, variant):
    """The same program built by the reference and by the port."""
    ref = ref_compile(RefOp(kind=kind, size_bytes=1 << 16, group=tuple(range(n))),
                      algo, **dict(akw))
    port = compile_op(CollectiveOp(kind=kind, size_bytes=1 << 16,
                                   group=tuple(range(n))), algo, **dict(akw))
    if variant == "permuted":
        perm = list(range(n))
        random.Random(n).shuffle(perm)
        ref, port = ref_permute(ref, perm), apply_permutation(port, perm)
    elif variant == "chunked":
        ref, port = ref_chunk(ref, 2), chunk(port, 2)
    return ref, port


def _flows(program):
    return [[(f.src, f.dst, f.size, f.op, f.chunks) for f in rnd]
            for rnd in program.rounds]


def _steps(schedule):
    return [[(s.links, s.op, s.chunks, s.send_mask, s.recv_mask, s.round_index)
             for s in rnd] for rnd in schedule.rounds]


def test_matrix_covers_every_registered_algorithm():
    assert set(registered_builders()) == set(ref_registered())
    assert {algo for algo, *_ in MATRIX} == set(registered_builders())
    for kind in ("allreduce", "all_gather", "reduce_scatter", "all_to_all"):
        for n in (4, 8, 16):
            assert candidates(kind, n) == ref_candidates(kind, n)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("algo,kind,n,akw", MATRIX, ids=IDS)
def test_program_and_lowering_equal_the_reference(algo, kind, n, akw, variant):
    ref, port = _both(algo, kind, n, akw, variant)
    validate(port)
    assert _flows(port) == _flows(ref)
    for field in ("perm", "n_chunks", "chunk_bytes", "init", "postcondition",
                  "cost_model", "chunk_factor", "algo_kwargs"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.fingerprint() == ref.fingerprint()
    assert [[(f.src, f.dst, f.size) for f in r] for r in port.to_flows()] == \
        [[(f.src, f.dst, f.size) for f in r] for r in ref.to_flows()]

    ref_s = JaxExecutor().lower_schedule(ref)
    port_s = ScheduleLowering().lower_schedule(port)
    assert _steps(port_s) == _steps(ref_s)
    assert port_s.order == ref_s.order
    assert port_s.rank_of == ref_s.rank_of
    assert port_s.source_fingerprint == ref_s.source_fingerprint
    assert port_s.fingerprint() == ref_s.fingerprint()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("algo,kind,n,akw", MATRIX, ids=IDS)
def test_require_certified_accepts_every_lowering(algo, kind, n, akw, variant):
    ref, port = _both(algo, kind, n, akw, variant)
    sched = ScheduleLowering().lower_schedule(port)
    stats = require_certified(port, sched)
    want = ref_require_certified(ref, JaxExecutor().lower_schedule(ref))
    assert stats == want
    assert stats["bisimilar"] and stats["n_mismatched_entries"] == 0
    # the schedule's symbolic end state is the program's postcondition
    full = frozenset(range(n))
    end = symbolic_execute(sched)
    if port.postcondition == "allreduce":
        assert all(end[r][c] == full for r in range(n)
                   for c in range(port.n_chunks))


def _ring8():
    prog = apply_permutation(
        compile_op(CollectiveOp("allreduce", 1 << 12, tuple(range(8))), "ring"),
        [0, 3, 1, 7, 2, 6, 4, 5])
    return prog, ScheduleLowering().lower_schedule(prog)


def test_require_certified_rejects_a_dropped_link():
    prog, sched = _ring8()
    rnds = list(sched.rounds)
    step = rnds[0][0]
    rnds[0] = (dataclasses.replace(step, links=step.links[1:],
                                   chunks=step.chunks[1:]),) + rnds[0][1:]
    broken = dataclasses.replace(sched, rounds=tuple(rnds))
    with pytest.raises(VerificationError, match="LOST_REDUCTION"):
        require_certified(prog, broken)
    findings, stats = bisimulate(prog, broken)
    assert not stats["bisimilar"]
    assert "LOST_REDUCTION" in {f.code for f in findings}


def test_require_certified_rejects_a_swapped_tag():
    prog, sched = _ring8()
    rnds = list(sched.rounds)
    rnds[0] = (dataclasses.replace(rnds[0][0], op="copy"),) + rnds[0][1:]
    with pytest.raises(VerificationError):
        require_certified(prog, dataclasses.replace(sched, rounds=tuple(rnds)))


def test_fuse_rounds_matches_the_reference_and_stays_certified():
    from repro.collective.passes import fuse_rounds as ref_fuse

    for algo in ("double_binary_tree", "ring"):
        op = dict(kind="allreduce", size_bytes=1 << 12, group=tuple(range(8)))
        port, k = fuse_rounds(compile_op(CollectiveOp(**op), algo))
        ref, k_ref = ref_fuse(ref_compile(RefOp(**op), algo))
        assert k == k_ref and _flows(port) == _flows(ref)
        require_certified(port, ScheduleLowering().lower_schedule(port))


# -- the reference's lowering mutants ----------------------------------------

def _to_port(schedule):
    """A reference ``LoweredSchedule`` field for field in the port's IR."""
    from repro_torch.collective.executors import LoweredSchedule, PermuteStep

    rounds = tuple(tuple(PermuteStep(**{f.name: getattr(s, f.name)
                                        for f in dataclasses.fields(PermuteStep)})
                         for s in rnd) for rnd in schedule.rounds)
    fields = {f.name: getattr(schedule, f.name)
              for f in dataclasses.fields(LoweredSchedule) if f.name != "rounds"}
    return LoweredSchedule(rounds=rounds, **fields)


def _error_codes(exc):
    return [(f.code, f.round) for f in exc.report.findings
            if f.severity == "error"]


MUTANT_PROGRAMS = [case for case in MATRIX if case[2] == 8]


@pytest.mark.parametrize("algo,kind,n,akw", MUTANT_PROGRAMS,
                         ids=[f"{a}-{k}-n{n}" for a, k, n, _ in MUTANT_PROGRAMS])
def test_require_certified_kills_the_reference_lowering_mutants(algo, kind, n, akw):
    """Every mutant ``repro.analysis.mutate.lowering_mutants`` draws (a
    dropped step, a flipped mask bit, a swapped reduce/copy tag), carried
    into the port's IR, is refused with the reference's error findings."""
    from repro.analysis import VerificationError as RefVerificationError
    from repro.analysis.mutate import lowering_mutants

    ref, port = _both(algo, kind, n, akw, "permuted")
    mutants = lowering_mutants(ref, seed=0)
    assert mutants
    for mkind, m in mutants:
        mutant = _to_port(m)
        assert mutant.fingerprint() == m.fingerprint()
        with pytest.raises(RefVerificationError) as want:
            ref_require_certified(ref, m)
        with pytest.raises(VerificationError) as got:
            require_certified(port, mutant)
        assert _error_codes(got.value) == _error_codes(want.value), mkind
        assert str(got.value).split(":")[1] == str(want.value).split(":")[1]
