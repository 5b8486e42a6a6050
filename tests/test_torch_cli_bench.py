"""``python -m repro_torch bench|analyze|status|trace`` against ``python -m repro``.

Each command runs in process through both packages' ``cli.main`` on the
same seed and flags; the JSON they write is compared with every time
(a key ending ``_s``, ``_ms`` or ``_x``) dropped.  The overlap scenario's
modeled section is compared with the reference benchmark's own functions
(numpy; its host section, which spawns an 8-device JAX process, is never
run here), and the port's host section runs once on the CPU, held to the
JAX baseline step's loss.
"""

import contextlib
import io
import itertools
import json
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.cli as ref_cli  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
import repro_torch.cli as port_cli  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data import host_batch as jax_host_batch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro_torch.bench import overlap_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import overlap_grads  # noqa: E402


def _untimed(x):
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items()
                if not k.endswith(("_s", "_ms", "_x"))}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


def _both(argv, tmp_path):
    """Run ``argv`` through both CLIs with ``--out``; returns their exit
    codes, stdouts and JSON (reference first)."""
    out = []
    path = tmp_path / "out.json"              # one path: the same stdout
    for cli in (ref_cli, port_cli):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv) + ["--out", str(path)])
        out.append((rc, buf.getvalue(), json.loads(path.read_text())))
    return out


@pytest.mark.parametrize("scenario", ["plan", "faults"])
def test_bench_json_equals_the_reference(scenario, tmp_path):
    (ref_rc, _, want), (rc, text, got) = _both(
        ["bench", "--smoke", "--scenario", scenario], tmp_path)
    assert rc == ref_rc == 0
    assert _untimed(got) == _untimed(want)
    if scenario == "plan":
        assert got["results"][0]["cache_hits"] == 1 and "bench,n=16," in text
    else:
        assert [e["kind"] for e in got["events"]] == ["node_preempt", "node_join"]
        assert all(e["ok"] for e in got["events"]) and got["health"] == "healthy"
        assert "bench_faults,node_preempt," in text


def test_bench_obs_replay_equals_the_reference(tmp_path):
    (_, _, want), (rc, _, got) = _both(
        ["bench", "--smoke", "--scenario", "obs"], tmp_path)
    assert got["replay"] == want["replay"]
    assert got["replay"]["phased_beats_declared"] and got["replay"]["windows"] == 6
    assert set(got["compile"]) == set(want["compile"])
    # the port times 15 pairs in turns where the reference times 5 a mode
    assert (got["compile"]["reps"], want["compile"]["reps"]) == (15, 5)
    # the exit code is the reference's gates on what was measured
    assert rc == (1 if got["compile"]["overhead_pct"] >= 10.0 else 0)


@pytest.mark.parametrize("mode", [[], ["--equiv"]])
def test_analyze_json_equals_the_reference(mode, tmp_path):
    (ref_rc, ref_text, want), (rc, text, got) = _both(
        ["analyze", "--n-list", "4,8"] + mode, tmp_path)
    assert rc == ref_rc == 0 and text == ref_text
    assert got == want and got["n_bad"] == 0 and got["n_programs"] >= 20


def test_analyze_program_prints_the_references_report(capsys):
    argv = ["analyze", "--program", "ring", "--nodes", "8"]
    assert ref_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert port_cli.main(argv) == 0
    assert capsys.readouterr().out == want and "ring" in want
    assert port_cli.main(["analyze", "--program", "halving_doubling",
                          "--nodes", "6"]) == ref_cli.main(
        ["analyze", "--program", "halving_doubling", "--nodes", "6"]) == 1


def test_trace_replay_json_equals_the_reference(tmp_path):
    (ref_rc, ref_text, want), (rc, text, got) = _both(
        ["trace", "replay", "--iters", "60"], tmp_path)
    assert rc == ref_rc == 0 and text == ref_text
    assert got == want and (got["n"], got["windows"]) == (16, 6)
    # a trace file written by the reference replays in the port
    path = tmp_path / "bursty.json"
    ref_obs.synthetic_bursty_trace(6, seed=2, steps=2).save(str(path))
    (_, ref_text, want), (_, text, got) = _both(
        ["trace", "replay", "--iters", "40", "--trace", str(path)], tmp_path)
    assert got == want and text == ref_text and (got["n"], got["windows"]) == (6, 2)


@contextlib.contextmanager
def _fresh_obs():
    """Fresh metrics and tracers in both packages (each tracer's clock
    steps by one), restored after."""
    def clock():
        c = itertools.count()
        return lambda: float(next(c))

    prev = [(mod, mod.set_metrics(mod.MetricsRegistry()),
             mod.set_tracer(mod.Tracer(clock=clock())))
            for mod in (ref_obs, port_obs)]
    try:
        yield
    finally:
        for mod, m, t in prev:
            mod.set_metrics(m)
            mod.set_tracer(t)


def test_status_shows_the_references_metrics(capsys):
    argv = ["status", "--nodes", "16", "--format", "prom"]
    with _fresh_obs():
        assert ref_cli.main(argv) == 0
        want = capsys.readouterr().out
        assert port_cli.main(argv) == 0
        got = capsys.readouterr().out
        snap = port_obs.metrics().snapshot()
    types = [ln for ln in got.splitlines() if ln.startswith("# TYPE")]
    assert types == [ln for ln in want.splitlines() if ln.startswith("# TYPE")]
    assert len(types) >= 5 and snap["counters"] and snap["histograms"]
    with _fresh_obs():
        assert port_cli.main(["status", "--no-run"]) == 0
        assert json.loads(capsys.readouterr().out) == {
            "counters": {}, "gauges": {}, "histograms": {}}


def test_trace_export_writes_the_references_spans(tmp_path, capsys):
    docs = []
    with _fresh_obs():
        for name, cli in (("ref", ref_cli), ("port", port_cli)):
            path = tmp_path / f"{name}.json"
            assert cli.main(["trace", "export", "--nodes", "16",
                             "--out", str(path)]) == 0
            docs.append(json.loads(path.read_text())["traceEvents"])
    assert "[trace] wrote" in capsys.readouterr().out

    def spans(events):
        return [(e["name"], e["ph"], e["tid"]) for e in events]

    assert spans(docs[1]) == spans(docs[0])
    names = {e["name"] for e in docs[1]}
    assert {"session.attach", "session.plan"} <= names, names


def test_every_reference_subcommand_and_flag_exists():
    def tree(parser):
        out = {}
        for action in parser._actions:
            if action.choices and hasattr(action.choices, "items"):
                for name, sub in action.choices.items():
                    out[name] = tree(sub)
            else:
                out.setdefault("", set()).update(action.option_strings)
        return out

    def covers(port, ref, where=()):
        for key, val in ref.items():
            assert key in port, where + (key,)
            if isinstance(val, set):
                assert val <= port[key], (where, val - port[key])
            else:
                covers(port[key], val, where + (key,))

    ref_tree = tree(ref_cli.build_parser())
    port_tree = tree(port_cli.build_parser())
    covers(port_tree, ref_tree)
    assert set(port_tree["trace"]) == {"", "export", "replay"}
    assert "--device" in port_tree["bench"][""]
    with pytest.raises(SystemExit):
        port_cli.main(["--version"])
    with pytest.raises(SystemExit):
        port_cli.main(["bench", "--scenario", "nope"])


# -- the overlap scenario ------------------------------------------------

def test_overlap_modeled_section_equals_the_reference():
    """``_plan_overlap`` and ``_pipeline_model`` of the reference benchmark,
    called in process (numpy only), against the port's copies."""
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    from benchmarks import overlap_step as ref_ov

    port_ov = overlap_step

    want, got = ref_ov._plan_overlap(0), port_ov._plan_overlap(0)
    assert got == want
    assert (got["algo"], got["algo_fallback"], got["chunks"], got["perm"],
            got["n_buckets"]) == ("ring", True, 1, [0, 1, 2, 3, 7, 5, 4, 6], 4)
    assert port_ov._pipeline_model(got) == ref_ov._pipeline_model(want)
    assert port_ov._pipeline_model(got)["speedup_bucketed_vs_sequential"] >= \
        port_ov.SPEEDUP_FLOOR
    assert (port_ov.N, port_ov.SIZE, port_ov.SPEEDUP_FLOOR) == (
        ref_ov.N, ref_ov.SIZE, ref_ov.SPEEDUP_FLOOR)


def test_overlap_host_section_on_the_cpu(tmp_path, monkeypatch):
    """``run(smoke=True, device="cpu", reps=1)``: the baseline and bucketed
    losses against the JAX baseline step's on the same weights, the
    postcondition, the gate, and what each timer times.  A clock that
    steps by one stamps every rank's ``value_and_grad``: compute-only must
    hold all 8 ranks' backward passes (``stacked_grads``), comm-only none."""
    jcfg = jax_get_config("qwen2-0.5b").smoke()
    jm = jax_get_model(jcfg)
    jbatch = jax_host_batch(JaxSyntheticLM(jcfg.vocab_size, 16, 8, seed=0), 0)
    # one weight tree for both: the port's seed-0 draw, in JAX's layout
    gen = torch.Generator()
    gen.manual_seed(0)
    params = get_model(get_config("qwen2-0.5b").smoke(), device="cpu").init(gen)
    # the JAX baseline step's loss metric: model.loss at the step's params
    jax_loss = float(jax.jit(jm.loss)(
        jax.tree.map(lambda t: t.numpy(), params), jbatch))

    ticks = itertools.count()
    tracer = port_obs.Tracer(enabled=True, clock=lambda: float(next(ticks)))
    stamps = []
    inner = overlap_grads.value_and_grad

    def stamped(*args, **kwargs):
        stamps.append(tracer.clock() - tracer._epoch)
        return inner(*args, **kwargs)

    monkeypatch.setattr(overlap_grads, "value_and_grad", stamped)
    prev = port_obs.set_tracer(tracer)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            res = overlap_step.run(smoke=True, device="cpu", reps=1,
                                   params=params,
                                   out_path=str(tmp_path / "ov.json"))
    finally:
        port_obs.set_tracer(prev)
    host = res["host"]
    assert res["gate_ok"] and host["postcondition_ok"] and host["bucketed_loss_ok"]
    np.testing.assert_allclose(host["baseline_loss"], jax_loss, rtol=2e-5)
    np.testing.assert_allclose(host["bucketed_loss"], jax_loss, rtol=2e-5)
    assert (host["device"], host["transport"], host["reps"], host["config"]) == (
        "cpu", "runner", 1, "qwen2-0.5b-smoke")
    assert host["buckets"] == 3 and host["bucket_bytes"] == host["param_bytes"] / 2
    assert "overlap_gate,0.000,post_ok=True;OK" in buf.getvalue()
    written = json.loads((tmp_path / "ov.json").read_text())
    assert written["host"] == host and written["meta"]["seed"] == 0

    spans = {r[1]: (r[2], r[2] + r[3]) for r in tracer.records()
             if r[0] == "X" and r[1].startswith("bench.")}
    assert set(spans) == {"bench.base", "bench.bucketed", "bench.comm_only",
                          "bench.compute_only"}

    def inside(name):
        t0, t1 = spans[name]
        return sum(t0 < s < t1 for s in stamps)

    assert inside("bench.compute_only") == overlap_step.N      # 8 ranks, 1 rep
    assert inside("bench.bucketed") == overlap_step.N
    assert inside("bench.comm_only") == 0 and inside("bench.base") == 0
    assert host["exposed_comm_fraction"] == pytest.approx(
        max(0.0, host["bucketed_s"] - host["compute_only_s"]) / host["bucketed_s"])
