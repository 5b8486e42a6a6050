#!/usr/bin/env python3
"""The spread of ``bench --scenario obs``'s tracing-overhead reading.

    python3 tools/obs_gate_spread.py [--trials 30] [--ballast 3000000]

The scenario's gate fails at 10 % overhead of the enabled tracer over
``PlanCompiler.compile`` (16 nodes, 60 iterations; the reference times 5
calls a mode).
The true overhead is a few spans a compile; what the gate reads is mostly
how the host's call times wander.  This tool reads it ``--trials`` times
on the port's planner (numpy on the host; no device), several ways:

* ``blocks`` — the reference's timing: five compiles with the tracer off,
  then five with it on, the cyclic GC left as it is, the ratio of the two
  medians;
* from one series a trial of 15 pairs in turns (one untimed compile
  first, each pair in the other order than the last, the GC off):
  ``medians5`` (the ratio of the two modes' medians over the first 5
  pairs), ``pairs5`` (the median of the first 5 pairs' ratios),
  ``medians15`` and ``pairs15`` (the same over all 15: ``pairs15`` is what
  ``repro_torch.cli.run_obs_scenario`` reads);
* ``scenario`` — ``run_obs_scenario(smoke=True)``'s own reading.

``--ballast`` first allocates that many small dicts and keeps them, so a
GC pass costs what it costs in a process as large as ``chip_smoke.py``'s
after its model phases.  It prints each trial, the first trials' call
times in ms (off, then on), and one JSON object: each way's readings,
their least, median and largest, and how many crossed the gate.  It
times the host only: run it on the host whose numbers are to be read.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

GATE_PCT = 10.0
REPS = 5


def _pct(ratio: float) -> float:
    return (ratio - 1.0) * 100.0


def blocks(tr, compile_once) -> float:
    """The reference's block-by-block medians; the overhead in per cent."""
    med = {}
    for mode, enable in (("disabled", False), ("enabled", True)):
        tr.set_enabled(enable)
        samples = []
        for _ in range(REPS):
            t = tr.timer("bench.obs.compile")
            with t:
                compile_once()
            samples.append(t.elapsed)
        med[mode] = statistics.median(samples)
    tr.set_enabled(False)
    return _pct(med["enabled"] / med["disabled"])


def turns(tr, compile_once, pairs: int):
    """``(off, on)`` call times of ``pairs`` pairs in turns, GC off."""
    off, on = [], []
    gc.collect()
    gc.disable()
    try:
        tr.set_enabled(False)
        compile_once()
        for rep in range(pairs):
            for enable in ((False, True) if rep % 2 == 0 else (True, False)):
                tr.set_enabled(enable)
                t = tr.timer("bench.obs.compile")
                with t:
                    compile_once()
                (on if enable else off).append(t.elapsed)
    finally:
        tr.set_enabled(False)
        gc.enable()
    return off, on


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=30)
    ap.add_argument("--ballast", type=int, default=0,
                    help="small objects kept alive, for a large GC heap")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.cli import run_obs_scenario
    from repro_torch.fabric import make_datacenter, probe_fabric, scramble
    from repro_torch.obs import declared_mix, synthetic_bursty_trace
    from repro_torch.plan import PlanCompiler, SolveBudget

    ballast = [{"i": i} for i in range(args.ballast)]
    # the scenario's inputs at --smoke, seed 0
    fab, _ = scramble(make_datacenter(16, seed=0), seed=1)
    probe = probe_fabric(fab, seed=0)
    compiler = PlanCompiler(budget=SolveBudget(iters=60, chains=2))
    mix = declared_mix(synthetic_bursty_trace(16, seed=0))
    tr = obs.tracer()

    def compile_once():
        compiler.compile(probe, mix)

    ways = ("blocks", "medians5", "pairs5", "medians15", "pairs15",
            "scenario")
    readings = {w: [] for w in ways}
    for trial in range(args.trials):
        readings["blocks"].append(blocks(tr, compile_once))
        off, on = turns(tr, compile_once, 15)
        for k in (REPS, 15):
            readings[f"medians{k}"].append(_pct(
                statistics.median(on[:k]) / statistics.median(off[:k])))
            readings[f"pairs{k}"].append(_pct(statistics.median(
                a / b for a, b in zip(on[:k], off[:k]))))
        readings["scenario"].append(
            run_obs_scenario(smoke=True, seed=0)["compile"]["overhead_pct"])
        print(f"trial {trial}: " + ", ".join(
            f"{w} {readings[w][-1]:+.3f} %" for w in ways), flush=True)
        if trial < 4:
            print("  ms off " + " ".join(f"{x * 1e3:.1f}" for x in off)
                  + " | on " + " ".join(f"{x * 1e3:.1f}" for x in on),
                  flush=True)
    summary = {
        way: {"readings": v, "least": min(v), "median": statistics.median(v),
              "largest": max(v), "over_gate": sum(x >= GATE_PCT for x in v)}
        for way, v in readings.items()}
    summary.update(trials=args.trials, ballast=len(ballast))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
