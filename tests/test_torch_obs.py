"""The port's ``obs`` recorder against the reference's: metrics and traces.

``repro_torch.obs.metrics`` and ``repro_torch.obs.trace`` are copies of
``repro.obs.metrics`` and ``repro.obs.trace``; both packages are driven
through one sequence of calls and their records and exports compared.
Wall-clock times are excluded: each tracer reads a clock of its own that
steps by a fixed amount, and the timestamps and durations are dropped
before the comparison (the time-free fields must then be equal).
"""

import importlib
import itertools
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the modules (each package's ``obs.metrics`` name is also an accessor)
ref_metrics = importlib.import_module("repro.obs.metrics")
ref_trace = importlib.import_module("repro.obs.trace")
port_metrics = importlib.import_module("repro_torch.obs.metrics")
port_trace = importlib.import_module("repro_torch.obs.trace")


def _drive_metrics(mod):
    """One sequence of calls on a fresh registry; returns what it shows."""
    reg = mod.MetricsRegistry()
    out = []
    reg.counter("plan.cache.hits").inc()
    reg.counter("plan.cache.hits").inc(2.5)
    reg.counter("9lives:odd-name").inc(3)
    g = reg.gauge("health.state")
    g.set(4)
    g.inc(1.5)
    g.dec(0.25)
    h = reg.histogram("probe.seconds", scale=1e-6)
    for v in (3e-6, 1.5e-5, 2e-3, 0.0, 7.0):
        h.observe(v)
    reg.histogram("sizes").observe(1024)
    out.append(("counter", reg.counter("plan.cache.hits").value))
    out.append(("hist", h.count, h.sum, h.mean))
    out.append(("snapshot", reg.snapshot()))
    out.append(("prometheus", reg.to_prometheus()))
    reg.reset()
    out.append(("after reset", reg.snapshot(), reg.to_prometheus()))
    off = mod.MetricsRegistry(enabled=False)
    off.counter("x").inc()
    off.gauge("y").set(3)
    off.histogram("z").observe(1.0)
    out.append(("disabled", off.snapshot(), off.counter("x").value,
                off.histogram("z").summary()))
    return out


def test_metrics_records_and_exports_equal_the_reference():
    assert _drive_metrics(port_metrics) == _drive_metrics(ref_metrics)


def _drive_trace(mod, path):
    """One sequence of spans, events and exports on a tracer whose clock
    steps by 0.25 s a read; returns its records and exports without times."""
    ticks = itertools.count()
    tr = mod.Tracer(enabled=False, buffer=6, clock=lambda: next(ticks) * 0.25)
    seen = []
    with tr.span("dropped") as s:
        seen.append(("null span", s is mod.NULL_SPAN, s.set(a=1) is s))
    tr.event("dropped")
    with tr.timer("measured", k=1) as t:
        pass
    seen.append(("disabled", len(tr), t.elapsed > 0))
    tr.set_enabled(True)
    with tr.span("serve.prefill", batch=2, prompt_len=16) as outer:
        with tr.span("inner", shape=(2, 3)) as inner:
            inner.set(result=object.__name__)
        tr.event("tick", n=1, who=None)
        outer.set(tokens=[1, 2])
    with pytest.raises(RuntimeError):
        with tr.span("fails"):
            raise RuntimeError("boom")
    with tr.timer("cli.train.run", steps=3) as t:
        pass
    seen.append(("timer", t.elapsed > 0))
    seen.append(("records", [(ph, name, thread, depth, attrs) for
                             ph, name, _t0, _dur, thread, depth, attrs
                             in tr.records()]))
    seen.append(("chrome", _timeless(tr.to_chrome())))
    for i in range(4):                       # wrap the 6-slot ring
        tr.event("wrap", i=i)
    seen.append(("wrapped", len(tr), tr.emitted, tr.buffer))
    tr.set_buffer(3)
    seen.append(("resized", len(tr), tr.buffer))
    records = [(ph, name, thread, depth, attrs)
               for ph, name, _t0, _dur, thread, depth, attrs in tr.records()]
    doc = tr.to_chrome()
    n = tr.export(str(path))
    with open(path) as f:
        exported = json.load(f)
    tr.clear()
    return seen, records, _timeless(doc), n, _timeless(exported), len(tr)


def _timeless(doc):
    """A Chrome trace document without its timestamps and durations."""
    return {"traceEvents": [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                            for e in doc["traceEvents"]],
            "displayTimeUnit": doc["displayTimeUnit"]}


def test_trace_records_and_exports_equal_the_reference(tmp_path):
    port = _drive_trace(port_trace, tmp_path / "port.json")
    ref = _drive_trace(ref_trace, tmp_path / "ref.json")
    assert port == ref
    seen, records, doc, n, exported, left = port
    early = next(entry[1] for entry in seen if entry[0] == "records")
    assert [r[1] for r in early] == ["inner", "tick", "serve.prefill", "fails",
                                     "cli.train.run"]
    assert early[3][4] == {"error": "RuntimeError: boom"}
    assert [r[1] for r in records] == ["wrap"] * 3 and n == 3 and left == 0
    assert doc == exported
