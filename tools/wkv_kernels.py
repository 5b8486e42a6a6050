#!/usr/bin/env python3
"""The WKV kernels against their earlier designs, on one NVIDIA GPU.

    python3 tools/wkv_kernels.py

1. Builds ``src/repro_torch/kernels/csrc/wkv_chunked.cu`` and ``wkv_scan.cu``
   as shipped, as variants (text substitutions of their constants), with
   ``-DWKV_PROFILE`` (``clock64`` stamps of thread 0's phases), and the
   earlier versions kept under ``tools/wkv_pr17/`` as they were and with
   stamps inserted, and prints what ``-Xptxas -v`` says:

   * ``wkv_chunked``: ``shipped`` (the products on tensor cores,
     ``mma.sync`` in 3xTF32, the state in accumulator fragments, r~ k~^T
     a thread a pair of tokens), ``qk_two_threads`` (r~ k~^T two threads a
     pair, spread over every warp), ``fma`` (every product in
     f32 FMAs, a warp one of 4 channel groups of 32 columns), ``pipelined``
     (``fma`` with the next chunk's decays beside this chunk's products,
     one barrier a chunk), both under ``tools/wkv_variants/``, ``pr17``
     (one block of 256 threads a head, the state in shared memory);
   * ``wkv_scan``: ``shipped`` (64 columns a block, a warp one of 4 channel
     groups of 32 columns, 16-token stages), ``stage32`` (32-token
     stages), ``vb32`` (32 columns a block), ``g8`` (8 channel groups),
     ``cols2`` (two columns a thread, 128 threads a block:
     ``tools/wkv_variants/``), ``pr17`` (one block of 64 threads a head, a
     column a thread).
2. Holds each against its plain version at the path's tolerance, at the
   layer shape and at edges (K, V of 8, 48 and 64, chunks 8 and 32, a
   strided and a misaligned view), and a second launch to the same bits.
3. Times each by CUDA-graph replay at the rwkv6-1.6b layer shape ``[8,
   512, 32, 64]`` (chunk 16 for ``wkv_chunked``, 64 for ``wkv_scan``) in
   bf16 and f32, in turns (the list, then the list reversed).
4. Prints the profiled builds' cycles a block spends in each phase, per
   chunk (``wkv_chunked``) or per 64 tokens (``wkv_scan``), thread 0's
   view, averaged over blocks.

Its last lines are one JSON object of every number and the card's
``nvidia-smi`` name and power limit.  It exits nonzero without CUDA or if
a build disagrees with its plain version.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
LAYER = (8, 512, 32, 64, 64)           # B, S, H, K, V of rwkv6-1.6b's prefill
CHUNK = {"wkv_chunked": 16, "wkv_scan": 64}
PR17 = os.path.join(ROOT, "tools", "wkv_pr17")
VARIANTS_DIR = os.path.join(ROOT, "tools", "wkv_variants")
TOL = {"float32": (5e-4, 5e-3), "bfloat16": (2e-2, 1.6e-2)}

# clock64 stamps for the earlier sources: the shipped sources carry them
# under WKV_PROFILE; these insert the same macros and reader
PROF_HEAD = """
constexpr int kProf = {n};
__device__ unsigned long long g_prof[kProf + 1];
#define PROF_DECL long long prof_t = clock64(); long long prof_acc[kProf] = {{}};
#define PROF(i) do {{ if (threadIdx.x == 0) {{ const long long n_ = clock64(); \\
  prof_acc[i] += n_ - prof_t; prof_t = n_; }} }} while (0)
#define PROF_END if (threadIdx.x == 0) {{ for (int i_ = 0; i_ < kProf; ++i_) \\
  atomicAdd(&g_prof[i_], (unsigned long long)prof_acc[i_]); atomicAdd(&g_prof[kProf], 1ull); }}
"""
PROF_READER = """
extern "C" int {name}_prof(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  const unsigned long long zero[kProf + 1] = {{}};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)e;
}}
"""
# phases of thread 0, in the order of the stamps
PHASES = {
    "wkv_chunked": ["load wait", "barrier 1", "decays, v, bonus", "barrier 2",
                    "issue loads", "r~ k~^T", "y^T = S^T r~^T (mma)",
                    "state update (mma)", "barrier 3",
                    "y (halves, qk v by mma, bonus) + store"],
    "wkv_scan": ["load wait", "barrier 1", "y out, to f32, bonus", "barrier 2",
                 "issue loads", "recurrence", "last y out"],
    "wkv_chunked:pr17": ["loop top", "barrier", "loads", "barrier", "bonus",
                         "barrier", "decays", "barrier", "r~ k~^T", "barrier",
                         "y (r~ S_0 + qk v)", "barrier", "state update"],
    "wkv_scan:pr17": ["loop top", "barrier", "loads", "barrier", "recurrence"],
}


def _pr17_profiled(kind: str, text: str) -> str:
    """An earlier source with a stamp on either side of each barrier in the
    token loop and one at its end (thread 0 is column 0, which never leaves
    the scan's loop early)."""
    n = len(PHASES[f"{kind}:pr17"])
    text = text.replace("namespace {\n", "namespace {\n" + PROF_HEAD.format(n=n), 1)
    if kind == "wkv_chunked":
        loop = "  for (int c0 = 0; c0 < S; c0 += chunk) {\n"
        end = ("      s_state[i] = a * s_state[i] + acc;\n    }\n  }\n")
        new_end = ("      s_state[i] = a * s_state[i] + acc;\n    }\n"
                   f"    PROF({n - 1});\n  }}\n  PROF_END\n")
    else:
        loop = "  for (int s0 = 0; s0 < S; s0 += stage) {\n"
        end = ("      yb[(s0 + t) * y_s + j] = from_f32<T>((acc[0] + acc[1]) + "
               "(acc[2] + acc[3]));\n    }\n  }\n")
        new_end = end.replace("    }\n  }\n", f"    }}\n    PROF({n - 1});\n  }}\n"
                                               "  PROF_END\n")
    for anchor in (loop, end):
        if text.count(anchor) != 1:
            raise RuntimeError(f"{kind} pr17: no unique {anchor!r}")
    head, rest = text.split(loop)
    body, tail = rest.split(end)
    stamp = iter(range(n))
    out = []
    for line in body.split("\n"):
        if line.startswith("    __syncthreads();"):
            out.append(f"    PROF({next(stamp)});")
            out.append(line)
            out.append(f"    PROF({next(stamp)});")
        else:
            out.append(line)
    text = head + "  PROF_DECL\n" + loop + "\n".join(out) + new_end + tail
    return text + PROF_READER.format(name=kind)


# r~ k~^T on two threads a pair of tokens, each half the channels, the pairs
# spread over every warp
QK_TWO_THREADS = (
    '    const int npairs = chunk * (chunk - 1) / 2;\n    for (int p = tid; p < npairs; p += kThreads) {\n      int t = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);\n      while (t * (t - 1) / 2 > p) --t;\n      while ((t + 1) * t / 2 <= p) ++t;\n      const int s = p - t * (t - 1) / 2;\n      const float4* a4 = reinterpret_cast<const float4*>(s_rt + t * pF);\n      const float4* b4 = reinterpret_cast<const float4*>(s_kt + s * pF);\n      float acc0 = 0.f, acc1 = 0.f;\n      for (int q = 0; q < kKP / 4; ++q) {\n        const float4 x = a4[q], z = b4[q];\n        acc0 = fmaf(x.x, z.x, acc0);\n        acc1 = fmaf(x.y, z.y, acc1);\n        acc0 = fmaf(x.z, z.z, acc0);\n        acc1 = fmaf(x.w, z.w, acc1);\n      }\n      s_qk[s * pQ + t] = acc0 + acc1;\n    }\n',
    '    // pair p = (t, s), s < t, on threads 2p and 2p + 1, each half the channels\n    const int npairs = chunk * (chunk - 1) / 2;\n    for (int base = 0; base < 2 * npairs; base += kThreads) {\n      const int i = base + tid, p = i >> 1, half = i & 1;\n      float acc0 = 0.f, acc1 = 0.f;\n      int t = 0, s = 0;\n      if (p < npairs) {\n        t = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);\n        while (t * (t - 1) / 2 > p) --t;\n        while ((t + 1) * t / 2 <= p) ++t;\n        s = p - t * (t - 1) / 2;\n        const float4* a4 = reinterpret_cast<const float4*>(s_rt + t * pF) + half * kKP / 8;\n        const float4* b4 = reinterpret_cast<const float4*>(s_kt + s * pF) + half * kKP / 8;\n#pragma unroll\n        for (int q = 0; q < kKP / 8; ++q) {\n          const float4 x = a4[q], z = b4[q];\n          acc0 = fmaf(x.x, z.x, acc0);\n          acc1 = fmaf(x.y, z.y, acc1);\n          acc0 = fmaf(x.z, z.z, acc0);\n          acc1 = fmaf(x.w, z.w, acc1);\n        }\n      }\n      float acc = acc0 + acc1;\n      acc += __shfl_xor_sync(kFull, acc, 1);\n      if (p < npairs && half == 0) s_qk[s * pQ + t] = acc;\n    }\n')


def _vb(v):
    return ("constexpr int kVb = 64;", f"constexpr int kVb = {v};")


def _groups(g):
    return ("constexpr int kG = 4;", f"constexpr int kG = {g};")


# (source, extra nvcc flags, text substitutions) of each build
VARIANTS = {
    "wkv_chunked": {
        "shipped": (None, [], []),
        "qk_two_threads": (None, [], [QK_TWO_THREADS]),
        "fma": (os.path.join(VARIANTS_DIR, "wkv_chunked_fma.cu"), [], []),
        "pipelined": (os.path.join(VARIANTS_DIR, "wkv_chunked_pipelined.cu"), [], []),
        "profiled": (None, ["-DWKV_PROFILE"], []),
        "pr17": (os.path.join(PR17, "wkv_chunked.cu"), [], []),
        "pr17_profiled": (os.path.join(PR17, "wkv_chunked.cu"), [], "pr17"),
    },
    "wkv_scan": {
        "shipped": (None, [], []),
        "stage32": (None, [], [("constexpr int kStage = 16;",
                                "constexpr int kStage = 32;")]),
        "vb32": (None, [], [_vb(32)]),
        "g8": (None, [], [_groups(8)]),
        "cols2": (os.path.join(VARIANTS_DIR, "wkv_scan_cols2.cu"), [], []),
        "profiled": (None, ["-DWKV_PROFILE"], []),
        "pr17": (os.path.join(PR17, "wkv_scan.cu"), [], []),
        "pr17_profiled": (os.path.join(PR17, "wkv_scan.cu"), [], "pr17"),
    },
}
TIMED = {kind: [n for n in v if "profiled" not in n] for kind, v in VARIANTS.items()}


def _say(msg: str) -> None:
    print(f"[wkv_kernels] {msg}", flush=True)


def graph_ms(fn, iters: int) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in a CUDA
    graph and replayed between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _close(name, got, want, atol, rtol) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got.float()).all()) or \
            bool((err > atol + rtol * want.float().abs()).any()):
        raise AssertionError(f"{name}: off its plain version by {err.max().item():.3e}")
    return err.max().item()


def main() -> int:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import rwkv6_chunked as wc
    from repro_torch.kernels import rwkv6_scan as ws

    if not torch.cuda.is_available():
        print("wkv_kernels: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    _say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    out_dir = build.BUILD_DIR / "wkv_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()

    procs = {}
    for kind, variants in VARIANTS.items():
        for name, (base, flags, subs) in variants.items():
            with open(base or build.CSRC / f"{kind}.cu") as f:
                text = f.read()
            if subs == "pr17":
                text = _pr17_profiled(kind, text)
            else:
                for old, new in subs:
                    if text.count(old) != 1:
                        raise RuntimeError(f"{kind}:{name}: no unique {old!r}")
                    text = text.replace(old, new)
            src = out_dir / f"{kind}-{name}.cu"
            src.write_text(text)
            lib = out_dir / f"{kind}-{name}.so"
            cmd = build.nvcc_command(kind, lib, nvcc)
            cmd[-1] = str(src)
            cmd[1:1] = flags
            procs[f"{kind}:{name}"] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs, ptxas = {}, {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
        ptxas[key] = [ln.strip() for ln in log.splitlines()
                      if re.search(r"registers|spill|smem", ln)]
        for ln in ptxas[key]:
            _say(f"ptxas {key}: {ln}")

    def use(kind: str, name: str):
        build._libs[kind] = libs[f"{kind}:{name}"]
        (wc if kind == "wkv_chunked" else ws)._lib()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def inputs(B, S, H, K, V, dtype, lo=0.3, hi=0.999):
        r, k = (torch.randn((B, S, H, K), generator=gen, device="cuda") * 0.5
                for _ in range(2))
        v = torch.randn((B, S, H, V), generator=gen, device="cuda") * 0.5
        w = lo + (hi - lo) * torch.rand((B, S, H, K), generator=gen, device="cuda")
        u = torch.randn((H, K), generator=gen, device="cuda") * 0.1
        return [x.to(dtype) for x in (r, k, v, w)] + [u]

    def run(kind, args, chunk):
        if kind == "wkv_chunked":
            return wc.wkv_chunked_matmul(*args, chunk=chunk)
        return (ws.wkv_scan(*args, chunk=chunk),)

    def plain(kind, args, chunk):
        if kind == "wkv_chunked":
            return wc.wkv_chunked_matmul_plain(*args, chunk=chunk)
        return (ws.wkv_scan_plain(*args, chunk=chunk),)

    # -- 2. every build against its plain version ----------------------------
    edges = [((2, 64, 3, 64, 64), 16), ((1, 96, 2, 48, 48), 32),
             ((2, 32, 2, 8, 8), 8), ((1, 64, 2, 16, 40), 16), ((1, 40, 1, 7, 5), 8)]
    checks = 0
    for shape, chunk in edges + [(LAYER, None)]:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            args = inputs(*shape, dt)
            views = [("dense", args)]
            if shape[3] == shape[4] and shape != LAYER:
                # r, k, v, w as slices of one wider tensor (as the model's
                # heads of one projection): 16-byte aligned, and one element in
                K = shape[3]
                for label, at in (("aligned view", 8), ("offset view", 1)):
                    big = torch.randn(shape[:3] + (4 * K + 8,), generator=gen,
                                      device="cuda").to(dt)
                    sl = [big[..., at + i * K:at + (i + 1) * K] for i in range(4)]
                    big[..., at + 3 * K:at + 4 * K] = (
                        0.3 + 0.699 * sl[3].float().sigmoid()).to(dt)
                    views.append((label, sl + [args[4]]))
            for label, a in views:
                for kind in VARIANTS:
                    ch = chunk or CHUNK[kind]
                    want = plain(kind, a, ch)
                    for name in TIMED[kind] + ["profiled"]:
                        use(kind, name)
                        got = run(kind, a, ch)
                        again = run(kind, a, ch)
                        torch.cuda.synchronize()
                        if not all(torch.equal(x, z) for x, z in zip(got, again)):
                            raise AssertionError(f"{kind}:{name} {shape} {label}: a "
                                                 f"second launch differs")
                        _close(f"{kind}:{name} {shape} {dtype} {label} y", got[0],
                               want[0], *TOL[dtype])
                        if kind == "wkv_chunked":
                            _close(f"{kind}:{name} {shape} {dtype} {label} state",
                                   got[1], want[1], *TOL["float32"])
                        checks += 1
            del args, views
    _say(f"every build == plain within tolerance, second launch equal ({checks} checks)")

    # -- 3. times in turns; 4. profiles --------------------------------------
    times, profiles = {}, {}
    for kind in VARIANTS:
        chunk = CHUNK[kind]
        for dtype in ("bfloat16", "float32"):
            args = inputs(*LAYER, getattr(torch, dtype))
            row = {}
            names = TIMED[kind]
            for name in names + names[::-1]:
                use(kind, name)
                row.setdefault(name, []).append(
                    graph_ms(lambda: run(kind, args, chunk), 20))
            times.setdefault(kind, {})[dtype] = row
            _say(f"{kind} {dtype} {list(LAYER)} ms: "
                 + json.dumps({k: [round(v, 4) for v in vs] for k, vs in row.items()}))
            for name in ("profiled", "pr17_profiled"):
                use(kind, name)
                lib = libs[f"{kind}:{name}"]
                fn = getattr(lib, f"{kind}_prof")
                fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
                phases = PHASES[kind if name == "profiled" else f"{kind}:pr17"]
                buf = (ctypes.c_ulonglong * (len(phases) + 1))()
                run(kind, args, chunk)
                torch.cuda.synchronize()
                fn(buf)                                     # zero after a warm run
                run(kind, args, chunk)
                torch.cuda.synchronize()
                if fn(buf):
                    raise RuntimeError(f"{kind}:{name}: profile read failed")
                blocks = max(1, buf[len(phases)])
                per = LAYER[1] / (chunk if kind == "wkv_chunked" else 64)
                prof = {p: buf[i] / blocks / per for i, p in enumerate(phases)}
                profiles.setdefault(kind, {}).setdefault(dtype, {})[name] = {
                    "blocks": blocks, "cycles": prof, "sum": sum(prof.values())}
                _say(f"{kind}:{name} {dtype} thread 0's cycles a "
                     f"{'chunk' if kind == 'wkv_chunked' else '64 tokens'} "
                     f"({blocks} blocks): "
                     + json.dumps({k: round(v, 1) for k, v in prof.items()}))
            del args
            torch.cuda.empty_cache()
    B, S, H, K, V = LAYER
    bounds = {}
    tc = {"wkv_chunked": wc.tensor_core_flops(B, S, H, K, V, 16), "wkv_scan": 0}
    for kind, (moved, flops) in (("wkv_chunked", wc.work(B, S, H, K, V, 16, 2)),
                                 ("wkv_scan", ws.work(B, S, H, K, V, 2))):
        # products on tensor cores in three TF32 passes, the rest in f32
        bounds[kind] = {"bytes": moved, "flops": flops, "tensor_core_flops": tc[kind],
                        "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
                        "ops_ms": (3 * tc[kind] / TF32_FLOPS_PER_S
                                   + (flops - tc[kind]) / F32_FLOPS_PER_S) * 1e3}
        _say(f"{kind} bf16 bound: {json.dumps(bounds[kind])}")
    print(json.dumps({"times_ms": times, "cycles": profiles, "bounds": bounds,
                      "ptxas": ptxas}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
