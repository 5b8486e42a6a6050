"""The port's fault injection, workload capture, lint and stage certifier
against the reference's, on the same seeds and inputs.

``repro_torch.faults.inject``, the capture half of ``repro_torch.obs.capture``,
``repro_torch.analysis.lint`` and ``repro_torch.analysis.equiv.certify_stages``
are copies of the reference's; each test drives both packages with one
input and compares what they return.
"""

import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import repro.analysis as ref_analysis  # noqa: E402
import repro.analysis.lint as ref_lint  # noqa: E402
import repro.collective as ref_coll  # noqa: E402
import repro.fabric as ref_fabric  # noqa: E402
import repro.faults as ref_faults  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
import repro.plan as ref_plan  # noqa: E402
import repro_torch.analysis as port_analysis  # noqa: E402
import repro_torch.analysis.lint as port_lint  # noqa: E402
import repro_torch.collective as port_coll  # noqa: E402
import repro_torch.fabric as port_fabric  # noqa: E402
import repro_torch.faults as port_faults  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
import repro_torch.plan as port_plan  # noqa: E402

# every kind fires often enough over 12 ticks to show in the views
STORM = dict(ticks=12, timeout_rate=0.15, drop_rate=0.3, nan_rate=0.3,
             degrade_rate=0.3, straggler_rate=0.3, preempt_frac=0.25)


def _fabric(mod, n: int = 12):
    fab, _ = mod.scramble(mod.make_datacenter(n, seed=0), seed=1)
    return fab


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_schedules_equal_the_reference(seed):
    kw = dict(STORM, seed=seed)
    want = ref_faults.FaultSchedule.generate(16, **kw).to_dict()
    got = port_faults.FaultSchedule.generate(16, **kw).to_dict()
    assert got == want
    # each package reads the other's serialised schedule
    assert port_faults.FaultSchedule.from_dict(want).to_dict() == want
    assert ref_faults.FaultSchedule.from_dict(got).to_dict() == got


def _views(faults, fabric_mod, seed: int):
    """Every tick of one storm: the membership events, the alive set, the
    probed matrices (or the timeout) and the cost matrix."""
    sched = faults.FaultSchedule.generate(12, **dict(STORM, seed=seed))
    ff = faults.FaultyFabric(_fabric(fabric_mod), sched)
    out = []
    for tick in range(STORM["ticks"]):
        fired = [e.to_dict() for e in ff.advance()] if tick else []
        row = {"tick": ff.tick, "fired": fired, "alive": ff.alive(),
               "active": [e.kind for e in ff.active()],
               "meta": ff.meta.get("tick")}
        try:
            row["lat"], row["bw"] = ff.lat, ff.bw
            row["cost"] = ff.cost_matrix(1e6)
        except faults.ProbeTimeout as e:
            row["timeout"] = str(e)
        out.append(row)
    return out, ff


def test_faulty_fabric_views_equal_the_reference_at_every_tick():
    want, ref_ff = _views(ref_faults, ref_fabric, 3)
    got, port_ff = _views(port_faults, port_fabric, 3)
    assert [r.get("timeout") for r in got] == [r.get("timeout") for r in want]
    assert any("timeout" in r for r in got)           # the storm times out
    assert any(r["fired"] for r in got)                # and churns
    kinds = {k for r in got for k in r["active"]}
    assert {"probe_drop", "probe_nan", "link_degrade", "straggler"} <= kinds
    for g, w in zip(got, want):
        for key in ("tick", "fired", "alive", "active", "meta"):
            assert g[key] == w[key], (g["tick"], key)
        for key in ("lat", "bw", "cost"):
            if key in w:
                np.testing.assert_array_equal(g[key], w[key])
    assert np.isinf(np.concatenate([r["lat"].ravel() for r in got
                                    if "lat" in r])).any()
    assert np.isnan(np.concatenate([r["lat"].ravel() for r in got
                                    if "lat" in r])).any()
    np.testing.assert_array_equal(port_ff.subset([0, 3, 5]).lat,
                                  ref_ff.subset([0, 3, 5]).lat)
    assert repr(port_ff) == repr(ref_ff)


@pytest.mark.parametrize("session_mod", ["repro.session", "repro_torch.session"])
def test_session_retries_an_injected_probe_timeout(session_mod):
    """The reference's ``test_probe_retries_through_transient_failure``:
    a fabric that times out twice, then heals, attaches through the retry
    policy; with no retries the timeout surfaces wrapped in RetryError."""
    import importlib

    pkg = "repro_torch" if session_mod.startswith("repro_torch") else "repro"
    faults = importlib.import_module(f"{pkg}.faults")
    fab_mod = importlib.import_module(f"{pkg}.fabric")
    Session = importlib.import_module(session_mod).Session
    SessionConfig = importlib.import_module(session_mod).SessionConfig

    def healing():
        ff = faults.FaultyFabric(_fabric(fab_mod), faults.FaultSchedule(events=(
            faults.FaultEvent("probe_timeout", tick=1, duration=2),), seed=0))

        class HealingFabric:
            def __getattr__(self, name):
                return getattr(ff, name)

            @property
            def lat(self):
                ff.advance()
                return ff.lat
        return HealingFabric()

    def cfg(retries):
        return SessionConfig().replace(
            mesh={"shape": ()}, cache={"dir": None},
            retry={"max_retries": retries, "base_delay_s": 0.001,
                   "jitter": 0.0})

    with Session(cfg(3)) as s:
        s.attach(healing())
        assert s.probe.n == 12
    with Session(cfg(0)) as s:
        with pytest.raises(faults.RetryError) as ei:
            s.attach(healing())
        assert isinstance(ei.value.last, faults.ProbeTimeout)


def _fold_and_replay(obs, plan_mod, fabric_mod, trace):
    fab = _fabric(fabric_mod, 16)
    probe = fabric_mod.probe_fabric(fab, seed=0)
    compiler = plan_mod.PlanCompiler(budget=plan_mod.SolveBudget(iters=40,
                                                                 chains=2))
    windows = obs.fold(trace, window_s=1.0)
    declared = obs.declared_mix(trace)
    plan = compiler.compile(probe, declared)
    # two phases' plans: a decode-like window and an optimizer-like one
    phased = [(w, compiler.compile(probe, w.mix)) for w in windows[:2]]
    return {
        "windows": [(w.t0, w.t1, w.n_records, w.mix.name, w.mix.key())
                    for w in windows],
        "whole": [w.mix.key() for w in obs.fold(trace)],
        "declared": (declared.name, declared.key(),
                     [dataclasses.astuple(r) for r in declared.requests]),
        "base": obs.replay(trace, plan, probe.lat, probe.bw),
        "phased": obs.replay(trace, plan, probe.lat, probe.bw, windows=phased),
        "lat_only": obs.replay(trace, plan, probe.lat),
    }


def test_fold_declared_mix_and_replay_equal_the_reference():
    want_trace = ref_obs.synthetic_bursty_trace(16)
    got_trace = port_obs.synthetic_bursty_trace(16)
    assert got_trace.to_json() == want_trace.to_json()
    want = _fold_and_replay(ref_obs, ref_plan, ref_fabric, want_trace)
    got = _fold_and_replay(port_obs, port_plan, port_fabric, got_trace)
    assert len(got["windows"]) == 6 and got["base"]["unplanned"] == 0
    assert got == want


def test_trace_files_load_in_either_package(tmp_path):
    ref_rec = ref_obs.WorkloadRecorder(enabled=True, clock=iter(
        [0.0, 0.5, 1.25, 2.0]).__next__)
    ref_rec.record("all-gather", 65536, [0, 1, 2])
    ref_rec.record("all-reduce", 2.5e8)
    ref_rec.record("all-to-all", 1e6, (3, 1))
    written_by_ref = tmp_path / "ref.json"
    ref_rec.trace("captured", meta={"n": 4}).save(str(written_by_ref))
    loaded = port_obs.WorkloadTrace.load(str(written_by_ref))
    assert (loaded.name, loaded.meta, len(loaded)) == ("captured", {"n": 4}, 3)
    assert [r.to_row() for r in loaded.records] == [
        ["all-gather", 65536.0, [0, 1, 2], 0.5], ["all-reduce", 2.5e8, None, 1.25],
        ["all-to-all", 1e6, [3, 1], 2.0]]

    written_by_port = tmp_path / "port.json"
    port_obs.synthetic_bursty_trace(8, seed=3).save(str(written_by_port))
    back = ref_obs.WorkloadTrace.load(str(written_by_port))
    assert back.to_json() == ref_obs.synthetic_bursty_trace(8, seed=3).to_json()
    assert port_obs.WorkloadTrace.from_json(back.to_json()).to_json() == \
        written_by_port.read_text()


# one planted violation of each rule (and one waived line), as files of a
# tree laid out like the repo's
PLANTED = {
    "src/repro/core/timing.py": (
        "import time\n"
        "import warnings\n"
        "import jax\n"
        "import numpy as np\n"
        "np.random.seed(0)\n"
        "rng = np.random.default_rng(0)\n"
        "\n"
        "def f():\n"
        "    t = time.perf_counter()\n"
        "    warnings.warn('slow')\n"
        "    warnings.warn('this is deprecated', UserWarning, stacklevel=2)\n"
        "    return t\n"
        "\n"
        "def g():\n"
        "    # lint: allow(raw-perf-counter): the probe's clock\n"
        "    return time.perf_counter()\n"),
    "src/repro/plan/build.py": (
        "from repro.collective.executors import LoweredSchedule\n"
        "\n"
        "def make():\n"
        "    return LoweredSchedule(n=2)\n"),
    "src/repro/train/step.py": (
        "import jax\n"
        "from repro.kernels.schedule_runner import run_schedule\n"
        "\n"
        "def step(x, s):\n"
        "    return run_schedule(x, s)\n"),
    "src/repro/analysis/fixture.py": (
        "def make(PermuteStep):\n"
        "    return PermuteStep()\n"),
    "tests/test_x.py": (
        "import time\n"
        "import jax\n"
        "import numpy\n"
        "numpy.random.rand(3)\n"
        "t = time.perf_counter()\n"),
}


def test_lint_findings_equal_the_reference(tmp_path):
    for rel, text in PLANTED.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    (tmp_path / "src" / "repro" / "core" / "broken.py").write_text("def (:\n")
    root = str(tmp_path)

    def findings(lint):
        found, n_files = lint.lint_repo(root)
        return n_files, [(f.rule, f.path, f.line, f.message, str(f))
                         for f in found]

    want = findings(ref_lint)
    got = findings(port_lint)
    assert got == want
    assert port_lint.RULES == ref_lint.RULES and len(port_lint.RULES) == 7
    assert {f[0] for f in got[1]} == set(port_lint.RULES) | {"syntax"}
    where = {(f[0], f[1], f[2]) for f in got[1]}
    assert ("raw-perf-counter", "src/repro/core/timing.py", 9) in where
    assert ("raw-perf-counter", "src/repro/core/timing.py", 16) not in where
    # tests may time freely, but not seed numpy's global state
    assert ("module-level-np-random", "tests/test_x.py", 4) in where
    assert not any(f[1] == "tests/test_x.py" and f[0] == "raw-perf-counter"
                   for f in got[1])
    one = str(tmp_path / "src" / "repro" / "plan" / "build.py")
    assert [dataclasses.astuple(f) for f in port_lint.lint_file(one, root)] == \
        [dataclasses.astuple(f) for f in ref_lint.lint_file(one, root)]
    assert port_lint.iter_python_files(root) == ref_lint.iter_python_files(root)


@pytest.mark.parametrize("algo,n", [("ring", 4), ("ring", 8),
                                    ("halving_doubling", 4),
                                    ("halving_doubling", 8)])
def test_certify_stages_equal_the_reference(algo, n):
    perm = list(range(n))
    random.Random(100 + n).shuffle(perm)

    def stages(coll, analysis):
        op = coll.CollectiveOp(kind="allreduce", size_bytes=1 << 20,
                               group=tuple(range(n)))
        prog = coll.compile_op(op, algo)
        return (analysis.certify_stages(prog, perm=perm, chunk_k=4),
                analysis.certify_stages(prog, fuse=False))

    want = stages(ref_coll, ref_analysis)
    got = stages(port_coll, port_analysis)
    assert got == want
    assert [s["stage"] for s in got[0]] == ["base", "apply_permutation",
                                            "chunk", "fuse_rounds"]
    assert all(s["ok"] for s in got[0]) and [s["stage"] for s in got[1]] == ["base"]

