"""Planned serving and the Session's lowering against the JAX package's.

One ``SessionConfig`` (a scrambled 8-node Clos datacenter, an 8-rank mesh,
the serving mix at 1e6 bytes) planned by both packages:
``Session.lower``/``ScheduleLowering.lower`` and ``Session.executor``
equal the reference's; the engine's ``collective_hints`` and
``lowered_collective`` equal the reference engine's; ``arm_overlap`` on the
smoke ``qwen2-0.5b`` and ``rwkv6-1.6b`` over 8 virtual ranks runs the
reference's schedule, and its tokens equal the unarmed engine's and JAX's
(weights carried across by ``params_from_jax``).
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.session as ref_session  # noqa: E402
from repro.collective import JaxExecutor  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serve import GenerationConfig as JaxGenerationConfig  # noqa: E402
from repro.serve import GenerationEngine as JaxGenerationEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.collective import (  # noqa: E402
    AnalyticExecutor,
    Lowered,
    ScheduleLowering,
    SimExecutor,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import GenerationConfig, GenerationEngine  # noqa: E402
from repro_torch.session import Session, SessionConfig  # noqa: E402

N = 8
PAYLOAD = 1e6
CFG = {
    "fabric": {"kind": "datacenter", "nodes": N, "scramble_seed": 1},
    "probe": {"n_probes": 64},
    "solver": {"budget": {"iters": 300, "chains": 2}},
    "mesh": {"shape": [N], "axis_names": ["data"]},
    "workload": "serve",
    "payload_bytes": PAYLOAD,
}
BATCH, PROMPT, NEW = 2, 8, 4


@pytest.fixture(scope="module")
def sessions():
    port = Session(SessionConfig.from_dict(CFG))
    ref = ref_session.Session(ref_session.SessionConfig.from_dict(CFG))
    port.plan()
    ref.plan()
    yield port, ref
    port.close()
    ref.close()


def _steps(schedule):
    return [[(s.links, s.op, s.chunks, s.send_mask, s.recv_mask, s.round_index)
             for s in rnd] for rnd in schedule.rounds]


def _assert_same_lowered(got, want):
    assert isinstance(got, Lowered)
    for field in ("kind", "order", "links", "shift_rounds", "fingerprint"):
        assert getattr(got, field) == getattr(want, field), field
    assert _steps(got.schedule) == _steps(want.schedule)
    assert got.schedule.fingerprint() == want.schedule.fingerprint()
    assert got.schedule.source_fingerprint == want.schedule.source_fingerprint


@pytest.mark.parametrize("op", ["all-reduce", "all-gather"])
def test_session_lower_equals_the_reference(sessions, op):
    port, ref = sessions
    assert port.planned.fingerprint.digest == ref.planned.fingerprint.digest
    counter = obs.metrics().counter(f"collective.lowered.{port.lower(op).kind}")
    before = counter.value
    got, want = port.lower(op), ref.lower(op)
    _assert_same_lowered(got, want)
    assert counter.value == before + 1
    entry, ref_entry = port.planned.lookup(op, PAYLOAD), ref.planned.lookup(op, PAYLOAD)
    lowering = port.executor("jax")
    assert isinstance(lowering, ScheduleLowering)
    assert lowering.can_lower(entry.program())
    _assert_same_lowered(lowering.lower(entry.program()),
                         JaxExecutor().lower(ref_entry.program()))
    for backend, cls in (("sim", SimExecutor), ("analytic", AnalyticExecutor),
                         ("auto", SimExecutor)):
        ex = port.executor(backend)
        assert isinstance(ex, cls)
        assert ex.estimate(entry.program()) == \
            ref.executor(backend).estimate(ref_entry.program())
    with pytest.raises(ValueError, match="unknown executor backend"):
        port.executor("xla")


def test_engine_hints_and_lowered_equal_the_reference(sessions):
    port, ref = sessions
    cfg = get_config("qwen2-0.5b").smoke()
    eng = GenerationEngine(get_model(cfg, device="cpu"), None, session=port)
    ref_eng = JaxGenerationEngine(jax_get_model(jax_get_config("qwen2-0.5b").smoke()),
                                  None, session=ref)
    assert eng.stats["plan_fingerprint"] == ref_eng.stats["plan_fingerprint"]
    assert eng.collective_hints(PAYLOAD) == ref_eng.collective_hints(PAYLOAD)
    assert set(eng.collective_hints(PAYLOAD)) == {"all-gather", "reduce-scatter"}
    for op in ("all-gather", "reduce-scatter"):
        _assert_same_lowered(eng.lowered_collective(op, PAYLOAD),
                             ref_eng.lowered_collective(op, PAYLOAD))
    assert eng.lowered_collective("all-to-all") is None
    assert GenerationEngine(eng.model, None).collective_hints() == {}


def _smoke(arch):
    """The smoke config on both sides; rwkv6's reference runs its exact
    recurrence (its kernel path drops the prefill state, ROADMAP.md §3)."""
    jcfg = jax_get_config(arch).smoke()
    cfg = get_config(arch).smoke()
    if arch == "rwkv6-1.6b":
        jcfg = dataclasses.replace(jcfg, wkv_impl="xla")
        cfg = dataclasses.replace(cfg, wkv_impl="kernel")
    return jcfg, cfg


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-1.6b"])
def test_armed_serving_equals_unarmed_and_jax(sessions, arch):
    port, ref = sessions
    jcfg, cfg = _smoke(arch)
    jm = jax_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = get_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (BATCH, PROMPT)).tolist()
    gen = GenerationConfig(max_new_tokens=NEW, eos_token=-1)
    want = JaxGenerationEngine(
        jm, jparams, JaxGenerationConfig(max_new_tokens=NEW, eos_token=-1)
    ).generate(prompts)
    unarmed = GenerationEngine(model, params, gen, session=port).generate(prompts)

    eng = GenerationEngine(model, params, gen, plan=port.planned)
    sched = eng.arm_overlap(make_mesh((N,), ("data",), "cpu"), "data", PAYLOAD)
    ref_sched = JaxExecutor().lower_schedule(
        ref.planned.lookup("all-gather", PAYLOAD).program())
    assert _steps(sched) == _steps(ref_sched)
    assert sched.fingerprint() == ref_sched.fingerprint()
    assert sched.postcondition == "all_gather"
    assert eng.stats["overlap_algo"] == ref_sched.algorithm
    ok = obs.metrics().counter("serve.overlap.postcondition_ok")
    before = ok.value
    prev = obs.set_tracer(obs.Tracer(enabled=True))
    try:
        armed = eng.generate(prompts)
        spans = [rec[1] for rec in obs.tracer().records()]
    finally:
        obs.set_tracer(prev)
    assert armed == unarmed == want
    assert all(len(row) == NEW for row in armed)
    assert ok.value == before + 1               # the wave's first gather
    assert "serve.overlap.prefill" in spans


def test_arm_overlap_refuses_without_a_plan_or_at_another_axis_size(sessions):
    port, _ = sessions
    model = get_model(get_config("qwen2-0.5b").smoke(), device="cpu")
    with pytest.raises(ValueError, match="needs a plan"):
        GenerationEngine(model, None).arm_overlap(
            make_mesh((N,), ("data",), "cpu"), "data")
    eng = GenerationEngine(model, None, plan=port.planned)
    with pytest.raises(ValueError, match="schedule wants 8"):
        eng.arm_overlap(make_mesh((4,), ("data",), "cpu"), "data", PAYLOAD)
    with pytest.raises(ValueError, match="no axis 'model'"):
        eng.arm_overlap(make_mesh((N,), ("data",), "cpu"), "model", PAYLOAD)
    assert eng._armed is None


def test_serve_cli_prints_the_plan_and_the_reference_hints(capsys):
    from repro_torch import cli

    argv = ["serve", "--mesh", str(N), "--reorder", "simulate", "--smoke",
            "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--max-new", "3"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("[serve] plan "))
    # the reference's launcher plans the same session on a one-pod fleet
    cfg = ref_session.SessionConfig().replace(
        fabric={"kind": "tpu-fleet", "n_pods": 1, "pod_shape": (N, 1),
                "scramble_seed": 0},
        mesh={"shape": (N,), "axis_names": ("data",)},
        payload_bytes=PAYLOAD, workload="serve")
    with ref_session.Session(cfg) as s:
        plan = s.plan(mix=ref_session.serve_mix(PAYLOAD))
    hints = JaxGenerationEngine(
        jax_get_model(jax_get_config("qwen2-0.5b").smoke()), None,
        plan=plan).collective_hints(PAYLOAD)
    assert line == f"[serve] plan {plan.fingerprint.digest} hints: {hints}"
    assert "[serve] arch=qwen2-0.5b-smoke 6 tokens" in out
    assert cli.main(["serve", "--dump-config"]) == 0
    assert json.loads(capsys.readouterr().out)["payload_bytes"] == PAYLOAD
