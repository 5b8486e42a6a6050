#!/usr/bin/env python3
"""One dry-run cell's depth-difference record, its two depths apart.

    python3 tools/dryrun_depth.py --arch rwkv6-1.6b --shape train_4k \\
        [--multi-pod] --depth 1 --out DIR
    python3 tools/dryrun_depth.py --arch rwkv6-1.6b --shape train_4k \\
        [--multi-pod] --combine DIR

``python -m repro_torch.launch.dryrun`` counts a cell at full depth and
then at depths 1 and 2 (``_depth_diff``).  A cell whose meta trace takes
longer than a run may last (rwkv6-1.6b's exact WKV recurrence walks its
4096 tokens a layer and a data-parallel rank in Python) can be given the
depth-difference record alone: ``--depth n`` measures the cell at depth
``n`` of ``_depth_variant`` (full width, the production mesh, every
tensor on ``meta``) and writes ``<arch>_<shape>_<sp|mp>_depth<n>.json``
under ``--out`` with the point's per-device FLOPs, bytes and collective
bytes and its host seconds; the two depths can run in two processes at
once.  ``--combine`` reads both points and prints the record
(``per_device``: the reference's keys and extrapolation,
``launch.dryrun.depth_extrapolate``) with the cell's status and the
roofline the reference derives from it (``source`` ``depth_diff``; no
full-depth count stands beside it, so its collective bytes are the
extrapolation's alone).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _path(out: str, arch: str, shape: str, multi_pod: bool, n: int) -> str:
    return os.path.join(out, f"{arch}_{shape}_{'mp' if multi_pod else 'sp'}"
                             f"_depth{n}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--depth", type=int, choices=(1, 2))
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--combine", default=None, metavar="DIR")
    ap.add_argument("--device", default="cuda",
                    help="the card the kernels would run on (the data "
                         "axis's transport); nothing is allocated there")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(args.arch)
    status, why = dryrun.cell_status(args.arch, args.shape, args.multi_pod)
    if args.combine:
        points = []
        for n in (1, 2):
            with open(_path(args.combine, args.arch, args.shape,
                            args.multi_pod, n)) as f:
                points.append(json.load(f))
        rec = {"arch": args.arch, "shape": args.shape,
               "mesh": "2x16x16" if args.multi_pod else "16x16",
               "status": status, "reason": why,
               "per_device": dryrun.depth_extrapolate(cfg, points),
               "collectives": {"total_bytes": 0.0},
               "depth_trace_s": [p["trace_s"] for p in points]}
        dryrun._finish_roofline(rec, cfg, SHAPES[args.shape],
                                512 if args.multi_pod else 256)
        del rec["collectives"]
        print(json.dumps(rec))
        return 0
    if args.depth is None:
        ap.error("--depth or --combine")
    if status != "ok":
        print(f"[dryrun_depth] {args.arch} x {args.shape}: {status} ({why})")
        return 1
    mesh = make_production_mesh(multi_pod=args.multi_pod, device=args.device)
    t0 = time.monotonic()
    point = dryrun.depth_point(cfg, SHAPES[args.shape], mesh, args.depth,
                               args.device)
    point["trace_s"] = time.monotonic() - t0
    os.makedirs(args.out, exist_ok=True)
    path = _path(args.out, args.arch, args.shape, args.multi_pod, args.depth)
    with open(path, "w") as f:
        json.dump(point, f)
    print(f"[dryrun_depth] {args.arch} x {args.shape} depth {args.depth}: "
          f"{json.dumps(point)} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
