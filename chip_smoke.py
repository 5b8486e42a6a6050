#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero (there
is no CPU fall-back, and without CUDA it stops before printing a result):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel under ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, in
   bf16 and f32, at the shapes the serving path gives it, and time both;
4. a small-input check: the smoke ``rwkv6`` in f32 on the card, the
   kernel-path prefill and three decode steps against the exact-recurrence
   path, and greedy tokens equal;
5. the main path: full-width ``rwkv6-1.6b`` (bf16, ``wkv_impl="kernel"``,
   random weights from ``--seed``) serves 8 requests of 512-token prompts
   and 32 new tokens through ``GenerationEngine.generate``; the kernel
   launch counts are zeroed just before and read just after;
6. prefill time, decode rate and peak memory of that configuration, and
   a ``torch.profiler`` window over one prefill and four decode steps
   (device busy share, kernel time by kind).

Its last lines are a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
#: FLOP/s outside the tensor cores; the WKV kernel's arithmetic is f32
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

BATCH, PROMPT, NEW = 8, 512, 32
# kernel vs plain on the same inputs: the same f32 math summed in another
# order (f32: the chunk-form tolerance of the CPU tests); bf16 y also
# rounds once to bf16 (2 ulps relative)
TOL = {"float32": (5e-4, 5e-3), "bfloat16": (2e-2, 1.6e-2)}


def _say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _check_close(name, got, want, atol, rtol) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool((err > limit).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err.max().item():.3e}, "
                             f"atol {atol}, rtol {rtol})")
    return err.max().item()


def check_wkv_kernel(seed: int) -> dict:
    """Phase 3: the WKV kernel against its plain version, and its times."""
    import torch

    from repro_torch.kernels import rwkv6_chunked as wk

    H, K, chunk = 32, 64, 16     # rwkv6-1.6b: 2048 / head_dim 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (BATCH, PROMPT, H, K)
    base = [torch.randn(shape, generator=gen, device="cuda") * 0.5 for _ in range(3)]
    w32 = 0.3 + 0.699 * torch.rand(shape, generator=gen, device="cuda")
    u32 = torch.randn((H, K), generator=gen, device="cuda") * 0.1
    errs, times = {}, {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        r, k, v = (x.to(dt) for x in base)
        w, u = w32.to(dt), u32.to(dt)
        y, s = wk.wkv_chunked_matmul(r, k, v, w, u, chunk=chunk)
        torch.cuda.synchronize()
        y_p, s_p = wk.wkv_chunked_matmul_plain(r, k, v, w, u, chunk=chunk)
        atol, rtol = TOL[dtype]
        errs[dtype] = _check_close(f"wkv_chunked y ({dtype})", y, y_p, atol, rtol)
        _check_close(f"wkv_chunked state ({dtype})", s, s_p, *TOL["float32"])
        times[dtype] = (
            _time_ms(lambda: wk.wkv_chunked_matmul(r, k, v, w, u, chunk=chunk), 20),
            _time_ms(lambda: wk.wkv_chunked_matmul_plain(r, k, v, w, u, chunk=chunk), 5),
        )
        _say(f"wkv_chunked {dtype} [{BATCH},{PROMPT},{H},{K}] chunk {chunk}: "
             f"max abs err vs plain {errs[dtype]:.3e}; kernel "
             f"{times[dtype][0]:.4f} ms, plain {times[dtype][1]:.4f} ms")
    moved, flops = wk.work(BATCH, PROMPT, H, K, K, chunk, 2)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    _say(f"wkv_chunked bf16 work: {moved} bytes, {flops} FLOP -> "
         f"{t_bytes:.4f} ms at 3.35 TB/s, {t_ops:.4f} ms at 67 TFLOP/s f32")
    return {
        "name": "wkv_chunked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv_chunked.cu",
        "replaces": "src/repro/kernels/rwkv6_chunked.py:105",
        "launches": None,            # filled from the main path's run
        "max_abs_err": errs["bfloat16"],
        "max_abs_err_f32": errs["float32"],
        "ms": times["bfloat16"][0],
        "plain_ms": times["bfloat16"][1],
        "ms_f32": times["float32"][0],
        "plain_ms_f32": times["float32"][1],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,          # no single PyTorch call computes WKV
    }


def check_small_model(seed: int) -> None:
    """Phase 4: kernel path == exact recurrence on the smoke config (f32)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, GenerationEngine

    base = get_config("rwkv6-1.6b").smoke()
    ref = get_model(dataclasses.replace(base, wkv_impl="xla"), device="cuda")
    ker = get_model(dataclasses.replace(base, wkv_impl="kernel"), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = ref.init(gen)
    params["blocks"]["time_mix"]["u"].normal_(0.0, 0.3, generator=gen)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, base.vocab_size, (2, 32))).cuda()
    with torch.inference_mode():
        la, ca = ker.prefill(params, toks)
        lb, cb = ref.prefill(params, toks)
        for _ in range(4):
            _check_close("smoke logits", la, lb, 1e-4, 1e-4)
            for name in cb:
                _check_close(f"smoke cache {name}", ca[name], cb[name], 1e-4, 1e-4)
            cur = lb.argmax(-1)
            la, ca = ker.decode_step(params, cur, ca)
            lb, cb = ref.decode_step(params, cur, cb)
    prompts = toks.tolist()
    cfg = GenerationConfig(max_new_tokens=8, eos_token=-1)
    a = GenerationEngine(ker, params, cfg).generate(prompts)
    b = GenerationEngine(ref, params, cfg).generate(prompts)
    if a != b:
        raise AssertionError(f"smoke greedy tokens differ: {a} vs {b}")
    _say("smoke rwkv6 f32 on the card: kernel-path prefill + decode == "
         "exact recurrence (atol/rtol 1e-4); greedy tokens equal")


def serve_full_width(seed: int, card: str, kernels: list) -> dict:
    """Phases 5 and 6: the main path at full width, counted, then timed."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_chunked
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, GenerationEngine

    counted = {"wkv_chunked": rwkv6_chunked.wkv_chunked_matmul}
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), wkv_impl="kernel")
    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).tolist()
    eng = GenerationEngine(model, params,
                           GenerationConfig(max_new_tokens=NEW, eos_token=-1))
    eng.generate([p[:16] for p in prompts], max_new_tokens=2)    # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.monotonic()
    outs = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the main path")
    if launches["wkv_chunked"] != cfg.n_layers:
        raise AssertionError(f"wkv_chunked launched {launches['wkv_chunked']} "
                             f"times in one prefill, expected {cfg.n_layers}")
    if len(outs) != BATCH or any(len(o) != NEW for o in outs):
        raise AssertionError(f"not every request got {NEW} tokens: "
                             f"{[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("generated token out of the vocabulary")

    tokens = torch.tensor(prompts, device="cuda")
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens)
        if tuple(logits.shape) != (BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"not finite / not [B, vocab]")
        prefill_ms = _time_ms(lambda: model.prefill(params, tokens), 3, warmup=1)
        cur = logits.argmax(-1)
        step_ms = _time_ms(lambda: model.decode_step(params, cur, cache), 10)
        profile_window("prefill", lambda: model.prefill(params, tokens))
        profile_window("decode x4", lambda: [model.decode_step(params, cur, cache)
                                             for _ in range(4)])
    res = {
        "arch": cfg.name, "params": n_params, "batch": BATCH,
        "prompt_len": PROMPT, "new_tokens": NEW,
        "generate_s": wall, "generated_tokens": sum(len(o) for o in outs),
        "prefill_ms": prefill_ms,
        "prefill_tok_per_s": BATCH * PROMPT / (prefill_ms / 1e3),
        "decode_step_ms": step_ms,
        "decode_tok_per_s": BATCH / (step_ms / 1e3),
        "peak_mem_gb": peak_gb, "launches": launches, "card": card,
    }
    _say(f"serve {cfg.name} ({n_params} params, bf16) batch {BATCH} x prompt "
         f"{PROMPT} x {NEW} new: {res['generated_tokens']} tokens in "
         f"{wall:.3f} s; prefill {prefill_ms:.3f} ms; decode "
         f"{step_ms:.3f} ms/step ({res['decode_tok_per_s']:.1f} tok/s); peak "
         f"memory {peak_gb:.3f} GB; wkv_chunked launches {launches['wkv_chunked']}"
         f" [{card}]")
    _say("serve " + json.dumps(res))
    return res


def _kind(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "wkv_chunked" in n:
        return "wkv_chunked"
    if any(s in n for s in ("nvjet", "gemm", "gemv", "xmma", "cutlass")):
        return "matmul"
    return "other"


def profile_window(label: str, fn) -> dict:
    """Device busy share and kernel time by kind over one run of ``fn``.

    From ``torch.profiler``'s CUDA kernel events: busy is the union of the
    kernels' intervals, the span runs from the first kernel's start to the
    last one's end.  The profiler adds host time to every op, so a
    host-bound window reads idler here than it runs unprofiled.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        _say(f"profile {label}: the profiler gave no device events; "
             f"device time not measured")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    span = max(e for _, e in spans) - spans[0][0]
    by_kind, by_name = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        by_kind[_kind(e.name)] = by_kind.get(_kind(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    res = {
        "window": label, "kernels": len(kern), "busy_ms": busy / 1e3,
        "span_ms": span / 1e3, "idle_share": 1.0 - busy / max(span, 1e-9),
        "ms_by_kind": {k: v / 1e3 for k, v in sorted(by_kind.items())},
        "top_ms": [[n[:90], v / 1e3] for n, v in top],
    }
    _say("profile " + json.dumps(res))
    return res


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    _say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    libs = build.build_all()
    _say(f"built {sorted(libs)} in {time.monotonic() - t0:.1f} s")
    for name, log in build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                _say(f"ptxas {name}: {line.strip()}")

    kernels = [check_wkv_kernel(args.seed)]
    check_small_model(args.seed)
    serve_full_width(args.seed, card, kernels)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
