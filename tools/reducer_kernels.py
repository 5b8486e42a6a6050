#!/usr/bin/env python3
"""The reducer kernels against their earlier designs and the library
calls, on one NVIDIA GPU.

    python3 tools/reducer_kernels.py

1. Builds ``src/repro_torch/kernels/csrc/peer_ring.cu`` and ``fused_add.cu``
   as shipped and as variants (text substitutions of its constants or
   code), the PR-16 versions kept under ``tools/reducer_pr16/`` (a
   round-major ring with its partials in device memory; a grid-stride
   add), and ``tools/l2_window.cu``, and prints what ``-Xptxas -v`` says:

   * ``peer_ring``: ``shipped`` (16 KB tiles, 2 FIFO slots, 3 input
     stages, one release a block with no fence on a hop, the refill after
     it), ``per_warp`` (a release a warp), ``under_loads`` (the refill
     issued under the step's loads), ``fenced`` (a fence on either side of
     a hop and a sleep in the spins: the kernel as first written),
     ``tile8k`` (8 KB tiles, 4 stages), ``slots4`` (4 slots), ``fifo32``
     (32 KB tiles, 2 stages, a 32 MiB FIFO budget), ``nohint`` (slot
     stores without the L2 evict-last hint), ``profiled`` (``clock64``
     stamps of thread 0's phases a step, read back through
     ``peer_ring_prof``), and ``cluster`` (the ring of a slice inside one
     thread-block cluster, partials handed on through distributed shared
     memory: ``tools/reducer_variants/peer_ring_cluster.cu``);
   * ``fused_add``: ``shipped`` (the register design: four 16-byte units
     a thread), ``register8`` (8 units a thread), ``bulk`` (the TMA bulk
     stream of ``tools/reducer_variants/fused_add_bulk.cu``: 2 blocks an
     SM, 3 stages of 2 x 16 KB), ``bulk1x6`` (1 block an SM, 6 stages).
2. Holds each against its plain version, bit for bit.
3. Times each by CUDA-graph replay, in turns (the list, then the list
   reversed): the ring at the training path's largest bucket ``[8,
   136134656]`` bf16 and at 4 MB a rank ``[8, 2097152]`` beside
   ``x.sum(0)``, the shipped ring also with an L2 access-policy window
   that pins its FIFO (set on the capturing stream); ``fused_add`` at
   68,067,776 elements in f32 and bf16, out of place and in place,
   beside ``torch.add``; then the shipped ring again on four fresh FIFOs
   at other addresses, the spread that placement alone gives.

Its last lines are one JSON object of every number and the card's
``nvidia-smi`` name and power limit.  It exits nonzero without CUDA or if
a variant disagrees with its plain version.
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
RANKS = 8
RING_SHAPES = {"largest": 136_134_656, "4MB": 2 * 1024 * 1024}
ADD_ELEMS = 68_067_776
PR16 = os.path.join(ROOT, "tools", "reducer_pr16")
RELEASE = ("      __syncthreads();\n      if (tid == 0) {\n"
           "        if (reads_slot) st_release(my_cons, base_c + w);\n"
           "        if (writes_slot) st_release(my_prod, base_p + w + 1);\n")
REFILL = ("        // the stages of the items consumed so far (k n + 2 + s) are free\n"
          "        if (kBulk)\n"
          "          while (issued < items && issued < k * n + 2 + s + kStages)\n"
          "            issue(issued++);\n")
# a release a warp (red.release after __syncwarp, 8 a step; the consumer
# waits for all 8) in place of one a block
PER_WARP = [
    ("__device__ __forceinline__ unsigned long long globaltimer() {",
     "__device__ __forceinline__ void red_release(unsigned int* p, unsigned int v) {\n"
     "  asm volatile(\"red.release.gpu.global.add.u32 [%0], %1;\" ::\"l\"(p), \"r\"(v)"
     " : \"memory\");\n}\n\n"
     "__device__ __forceinline__ unsigned long long globaltimer() {"),
    ("        if (reads_slot) ok = spin_until(pd_prod, base_c + w, t0);\n"
     "        if (ok && writes_slot && w >= (unsigned int)kSlots)\n"
     "          ok = spin_until(nx_cons, base_p + w - kSlots + 1, t0);\n",
     "        if (reads_slot) ok = spin_until(pd_prod, base_c + 8 * w, t0);\n"
     "        if (ok && writes_slot && w >= (unsigned int)kSlots)\n"
     "          ok = spin_until(nx_cons, base_p + 8 * (w - kSlots + 1), t0);\n"),
    (RELEASE,
     "      __syncwarp();\n      if (threadIdx.x % 32 == 0) {\n"
     "        if (reads_slot) red_release(my_cons, 1);\n"
     "        if (writes_slot) red_release(my_prod, 1);\n      }\n"
     "      __syncthreads();\n      if (tid == 0) {\n"),
]
# the refill issued under the step's loads, not after the releases
UNDER_LOADS = [
    (REFILL, ""),
    ("        if (s == 0) mbar_wait(&full[(m - 1) % kStages], ((m - 1) / kStages) & 1);\n",
     "        if (tid == 0)\n          while (issued < items && issued <= m) issue(issued++);\n"
     "        if (s == 0) mbar_wait(&full[(m - 1) % kStages], ((m - 1) / kStages) & 1);\n"),
    ("#pragma unroll\n        for (int e = 0; e < kBatch; ++e) {\n"
     "          const int u = b0 + tid + e * kThreads;\n          if (u >= cnt) continue;\n",
     "        if (kBulk && tid == 0 && b0 == 0)\n"
     "          while (issued < items && issued < (s == 0 ? k * n : k * n + 1 + s) + kStages)\n"
     "            issue(issued++);\n"
     "#pragma unroll\n        for (int e = 0; e < kBatch; ++e) {\n"
     "          const int u = b0 + tid + e * kThreads;\n          if (u >= cnt) continue;\n"),
]
# a fence on either side of a hop and a 20 ns sleep in the spins, as the
# kernel was first written
FENCES = [
    ("  while ((int)(ld_acquire(p) - want) < 0)\n"
     "    if (globaltimer() - t0 > kTimeoutNs) return false;\n",
     "  while ((int)(ld_acquire(p) - want) < 0) {\n"
     "    if (globaltimer() - t0 > kTimeoutNs) return false;\n"
     "    __nanosleep(20);\n  }\n"),
    ("          s_abort = 1;\n        }\n",
     "          s_abort = 1;\n"
     "        } else if (reads_slot || writes_slot) {\n"
     "          asm volatile(\"fence.acq_rel.gpu;\" ::: \"memory\");\n        }\n"),
    ("        if (reads_slot) st_release(my_cons, base_c + w);\n",
     "        if (reads_slot || writes_slot)\n"
     "          asm volatile(\"fence.acq_rel.gpu;\" ::: \"memory\");\n"
     "        if (reads_slot) st_release(my_cons, base_c + w);\n"),
]
# the shipped ring with clock64 stamps: thread 0's cycles a step in (0)
# the spins and the barrier after them, (1) the wait for its TMA tiles, (2)
# its loads, adds and stores and the barrier after them, (3) the release
# stores; summed over blocks into peer_ring_prof
PROFILE = [
    ("  int issued = 0;   // items thread 0 has issued\n",
     "  int issued = 0;   // items thread 0 has issued\n"
     "  long long prof[5] = {0, 0, 0, 0, 0};\n"),
    ("      if (tid == 0) {\n        bool ok = true;\n",
     "      const long long c0 = clock64();\n"
     "      if (tid == 0) {\n        bool ok = true;\n"),
    ("      __syncthreads();\n      if (s_abort) {\n",
     "      __syncthreads();\n      const long long c1 = clock64();\n"
     "      if (s_abort) {\n"),
    ("      U* dst = writes_slot ?",
     "      const long long c2 = clock64();\n      U* dst = writes_slot ?"),
    (RELEASE,
     "      __syncthreads();\n      const long long c3 = clock64();\n"
     "      if (tid == 0) {\n"
     "        if (reads_slot) st_release(my_cons, base_c + w);\n"
     "        if (writes_slot) st_release(my_prod, base_p + w + 1);\n"
     "        prof[0] += c1 - c0; prof[1] += c2 - c1; prof[2] += c3 - c2;\n"
     "        prof[3] += clock64() - c3; ++prof[4];\n"),
    ("    }\n  }\n}\n\ntemplate <typename U>\nint resident_blocks",
     "    }\n  }\n  if (tid == 0)\n    for (int q = 0; q < 5; ++q)\n"
     "      atomicAdd(&g_prof[q], (unsigned long long)prof[q]);\n}\n\n"
     "template <typename U>\nint resident_blocks"),
    ("template <typename U>\n__global__ void __launch_bounds__(kThreads, 4)",
     "__device__ unsigned long long g_prof[5];\n\n"
     "template <typename U>\n__global__ void __launch_bounds__(kThreads, 4)"),
    ('extern "C" {\n',
     'extern "C" {\n\n'
     "int peer_ring_prof(unsigned long long* out) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
     "  const unsigned long long zero[5] = {0, 0, 0, 0, 0};\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));\n"
     "  return (int)e;\n}\n\n"),
]
# (source, text substitutions) of each build; source None is the
# shipped one under src/repro_torch/kernels/csrc


def _tile(v):
    return ("constexpr int kTileBytes = 16384;", f"constexpr int kTileBytes = {v};")


def _stages(v):
    return ("constexpr int kStages = 3;", f"constexpr int kStages = {v};")


RING_VARIANTS = {
    "shipped": (None, []),
    "per_warp": (None, PER_WARP),
    "under_loads": (None, UNDER_LOADS),
    "fenced": (None, FENCES),
    "tile8k": (None, [_tile("8192"), _stages("4")]),
    "slots4": (None, [("constexpr int kSlots = 2;", "constexpr int kSlots = 4;")]),
    # twice the FIFO budget, 32 KB tiles and 2 stages: more bytes in flight
    "fifo32": (None, [_tile("32768"), _stages("2"),
                      ("kFifoBudget = 16ll << 20;", "kFifoBudget = 32ll << 20;")]),
    # slot stores without the evict-last hint
    "nohint": (None, [("          if (writes_slot)\n"
                       "            st_slot(dst + u, add_unit(ra[e], rb[e]), keep);\n",
                       "          if (writes_slot)\n"
                       "            __stcg(dst + u, add_unit(ra[e], rb[e]));\n")]),
    "profiled": (None, PROFILE),
    "pr16": (os.path.join(PR16, "peer_ring.cu"), []),
}
# (tile bytes, slots) of the builds that change them: the FIFO the wrapper
# allocates follows ring_collective's constants, set to these while a
# build is in use
RING_SCHEDULE = {"tile8k": (8192, 2), "slots4": (16384, 4),
                 "fifo32": (32768, 2)}
BULK = os.path.join(ROOT, "tools", "reducer_variants", "fused_add_bulk.cu")
CLUSTER = os.path.join(ROOT, "tools", "reducer_variants", "peer_ring_cluster.cu")
ADD_VARIANTS = {
    "shipped": (None, []),
    "register8": (None, [("constexpr int kRegUnits = 4;",
                          "constexpr int kRegUnits = 8;")]),
    "bulk": (BULK, []),
    "bulk1x6": (BULK, [("constexpr int kStages = 3;", "constexpr int kStages = 6;"),
                       ("constexpr int kCtasPerSm = 2;", "constexpr int kCtasPerSm = 1;")]),
    "pr16": (os.path.join(PR16, "fused_add.cu"), []),
}


def _say(msg: str) -> None:
    print(f"[reducer_kernels] {msg}", flush=True)


def graph_ms(fn, iters: int, stream=None) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in a CUDA
    graph (on ``stream`` if given) and replayed between CUDA events."""
    import torch

    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import ring_collective as rc

    if not torch.cuda.is_available():
        print("reducer_kernels: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    _say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    out_dir = build.BUILD_DIR / "reducer_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()

    jobs = {}
    for kind, variants in (("peer_ring", RING_VARIANTS), ("fused_add", ADD_VARIANTS)):
        for name, (base, subs) in variants.items():
            with open(base or build.CSRC / f"{kind}.cu") as f:
                text = f.read()
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{kind}:{name}: no unique {old!r}")
                text = text.replace(old, new)
            src = out_dir / f"{kind}-{name}.cu"
            src.write_text(text)
            jobs[f"{kind}:{name}"] = (kind, str(src))
    jobs["l2_window"] = ("l2_window", os.path.join(ROOT, "tools", "l2_window.cu"))
    jobs["ring_cluster"] = ("peer_ring", CLUSTER)
    procs = {}
    for key, (kind, src) in jobs.items():
        lib = out_dir / (key.replace(":", "-") + ".so")
        cmd = build.nvcc_command(kind, lib, nvcc)
        cmd[-1] = src
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib)
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

    shipped_schedule = (rc.RING_TILE_BYTES, rc.RING_SLOTS)

    def use(kind: str, name: str) -> None:
        build._libs[kind] = libs[f"{kind}:{name}"]
        if kind == "peer_ring":
            rc.RING_TILE_BYTES, rc.RING_SLOTS = RING_SCHEDULE.get(
                name, shipped_schedule)
            rc._ring_flags.clear()       # counters and FIFO of that build
            rc._ring_lib()
        else:
            rc._lib()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)

    # -- the PR-16 ring: its own scratch and counters ------------------------
    pr16 = libs["peer_ring:pr16"]
    p, i = ctypes.c_void_p, ctypes.c_int
    pr16.peer_ring_max_blocks.argtypes = [i, ctypes.POINTER(i)]
    pr16.peer_ring_fwd.argtypes = [i, i, p, p, p, p, p, ctypes.c_longlong, i, p, p]
    pr16.peer_ring_max_blocks.restype = pr16.peer_ring_fwd.restype = i
    most16 = ctypes.c_int(0)
    if pr16.peer_ring_max_blocks(RANKS, ctypes.byref(most16)):
        raise RuntimeError("pr16 peer_ring_max_blocks failed")
    flags16 = torch.zeros((RANKS, most16.value), dtype=torch.int32, device="cuda")
    status16 = torch.zeros(1, dtype=torch.int32, device="cuda")

    def pr16_ring(x, perm, scratch, out):
        n, L = x.shape
        C, item = L // n, x.element_size()
        rows = ctypes.c_ulonglong * n
        err = pr16.peer_ring_fwd(
            0 if x.dtype == torch.float32 else 1, n, (ctypes.c_int * n)(*perm),
            rows(*(x.data_ptr() + r * L * item for r in range(n))),
            rows(*(scratch.data_ptr() + r * (n - 2) * C * item for r in range(n))),
            rows(*(out.data_ptr() + r * C * item for r in range(n))),
            rows(*(flags16.data_ptr() + r * most16.value * 4 for r in range(n))),
            C, most16.value, status16.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pr16 peer_ring failed: CUDA error {err}")
        return out

    # -- the ring in a thread-block cluster: its own entry point ------------
    clu = libs["ring_cluster"].peer_ring_cluster_fwd
    clu.argtypes, clu.restype = [i, i, p, p, p, ctypes.c_longlong, p], i

    def cluster_ring(x, perm, out):
        n, L = x.shape
        C, item = L // n, x.element_size()
        rows = ctypes.c_ulonglong * n
        err = clu(0 if x.dtype == torch.float32 else 1, n, (ctypes.c_int * n)(*perm),
                  rows(*(x.data_ptr() + r * L * item for r in range(n))),
                  rows(*(out.data_ptr() + r * C * item for r in range(n))),
                  C, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cluster ring failed: CUDA error {err}")
        return out

    # -- 2. every variant against its plain version --------------------------
    checks = 0
    for width in (7, 1031, 8 * 4099, 5 * 8192 + 40, 131072):
        for dt in (torch.bfloat16, torch.float32):
            perm = [int(v) for v in rng.permutation(RANKS)]
            x = torch.randn((RANKS, RANKS * width), generator=gen,
                            device="cuda").to(dt)
            want = rc.remote_ring_reduce_scatter_plain(x, perm)
            for name in RING_VARIANTS:
                if name == "pr16":
                    continue
                use("peer_ring", name)
                got = rc.remote_ring_reduce_scatter(x, perm)
                torch.cuda.synchronize()
                if rc.ring_status() != 0 or not torch.equal(got, want):
                    raise AssertionError(f"peer_ring {name} != plain at width "
                                         f"{width} {dt}")
                checks += 1
            scratch = torch.empty((RANKS, (RANKS - 2) * width), dtype=dt, device="cuda")
            got = pr16_ring(x, perm, scratch, torch.empty_like(want))
            torch.cuda.synchronize()
            if int(status16.item()) != 0 or not torch.equal(got, want):
                raise AssertionError(f"peer_ring pr16 != plain at width {width}")
            checks += 1
            if width % (16 // x.element_size()) == 0:
                got = cluster_ring(x, perm, torch.empty_like(want))
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"peer_ring cluster != plain at width "
                                         f"{width} {dt}")
                checks += 1
    for n in (1000, (1 << 20) + 3):
        for dt in (torch.bfloat16, torch.float32):
            buf_a = torch.randn(n + 8, generator=gen, device="cuda").to(dt)
            buf_b = torch.randn(n + 8, generator=gen, device="cuda").to(dt)
            for oa, ob in ((0, 0), (3, 3), (1, 2)):
                a, b = buf_a[oa:oa + n], buf_b[ob:ob + n]
                want = rc.fused_add_plain(a, b)
                for name in ADD_VARIANTS:
                    use("fused_add", name)
                    got = rc.fused_add(a, b)
                    acc = a.clone()
                    rc.fused_add(acc, b, out=acc)
                    torch.cuda.synchronize()
                    if not (torch.equal(got, want) and torch.equal(acc, want)):
                        raise AssertionError(f"fused_add {name} != plain at n={n} "
                                             f"offsets {oa}, {ob}")
                    checks += 1
    _say(f"every variant == plain bit for bit ({checks} checks)")

    # -- 3. times, in turns --------------------------------------------------
    win = libs["l2_window"]
    win.l2_window_set.argtypes = [p, p, ctypes.c_ulonglong, ctypes.c_float]
    win.l2_window_clear.argtypes = [p]
    win.l2_window_set.restype = win.l2_window_clear.restype = ctypes.c_int
    prof_fn = libs["peer_ring:profiled"].peer_ring_prof
    prof_fn.argtypes, prof_fn.restype = [p], ctypes.c_int
    order = [0, 7, 3, 5, 2, 4, 1, 6]
    ring_times, ring_info, ring_profile, ring_spread = {}, {}, {}, {}
    for label, width in RING_SHAPES.items():
        x = torch.randn((RANKS, width), generator=gen, device="cuda").to(torch.bfloat16)
        iters = 5 if label == "largest" else 20
        scratch = torch.empty((RANKS, (RANKS - 2) * (width // RANKS)),
                              dtype=torch.bfloat16, device="cuda")
        out16 = torch.empty((RANKS, width // RANKS), dtype=torch.bfloat16,
                            device="cuda")
        row = {}
        names = [v for v in RING_VARIANTS if v != "profiled"] + [
            "window", "cluster", "x.sum(0)"]
        for name in names + names[::-1]:
            if name == "cluster":
                ms = graph_ms(lambda: cluster_ring(x, order, out16), iters)
            elif name == "pr16":
                ms = graph_ms(lambda: pr16_ring(x, order, scratch, out16), iters)
            elif name in RING_VARIANTS:
                use("peer_ring", name)
                ms = graph_ms(lambda: rc.remote_ring_reduce_scatter(x, order), iters)
                ring_info[name] = rc.ring_fifo(RANKS)
            elif name == "window":
                use("peer_ring", "shipped")
                fifo = rc._ring_state(x.device, RANKS, rc._ring_lib())[1]
                stream = torch.cuda.Stream()
                err = win.l2_window_set(stream.cuda_stream, fifo.data_ptr(),
                                        fifo.numel(), 1.0)
                if err:
                    raise RuntimeError(f"l2_window_set failed: CUDA error {err}")
                ms = graph_ms(lambda: rc.remote_ring_reduce_scatter(x, order),
                              iters, stream=stream)
                win.l2_window_clear(stream.cuda_stream)
            else:
                ms = graph_ms(lambda: x.sum(0), iters)
            torch.cuda.synchronize()
            if rc.ring_status() != 0 or int(status16.item()) != 0:
                raise AssertionError(f"peer_ring {name}: status word set while timing")
            row.setdefault(name, []).append(ms)
        use("peer_ring", "profiled")
        rc.remote_ring_reduce_scatter(x, order)       # allocate, then count
        torch.cuda.synchronize()
        prof = (ctypes.c_ulonglong * 5)()
        prof_fn(prof)
        rc.remote_ring_reduce_scatter(x, order)
        torch.cuda.synchronize()
        prof_fn(prof)
        steps = max(1, prof[4])
        ring_profile[label] = {"steps": steps, **{k: prof[q] / steps for q, k in enumerate(
            ("spin", "tma_wait", "load_add_store_barrier", "release"))}}
        _say(f"peer_ring [{RANKS}, {width}] thread 0's cycles a step: "
             + json.dumps({k: round(v, 1) for k, v in ring_profile[label].items()}))
        # the shipped ring on four fresh FIFOs, each at another address
        pads, spread = [], []
        for rep in range(4):
            pads.append(torch.empty((rep + 1) << 20, dtype=torch.uint8, device="cuda"))
            use("peer_ring", "shipped")
            ms = graph_ms(lambda: rc.remote_ring_reduce_scatter(x, order), iters)
            spread.append((rc._ring_flags[(x.device.index, RANKS)][1].data_ptr(), ms))
        ring_spread[label] = spread
        _say(f"peer_ring [{RANKS}, {width}] shipped on fresh FIFOs (address, ms): "
             + json.dumps([(hex(a), round(t, 4)) for a, t in spread]))
        del pads
        ring_b, fn_b = rc.ring_work(RANKS, width, 2)
        ring_times[label] = {"shape": [RANKS, width], "ms": row,
                             "bound_ms": fn_b / HBM_BYTES_PER_S * 1e3,
                             "ring_bound_ms": ring_b / HBM_BYTES_PER_S * 1e3}
        _say(f"peer_ring bf16 [{RANKS}, {width}] ms: "
             + json.dumps({k: [round(v, 4) for v in vs] for k, vs in row.items()})
             + f"; bound {ring_times[label]['bound_ms']:.4f} ms (function bytes)")
        del x, scratch, out16
        torch.cuda.empty_cache()
    for name, info in ring_info.items():
        _say(f"peer_ring {name}: FIFO {info}")

    add_times = {}
    for dt in (torch.bfloat16, torch.float32):
        a = torch.randn(ADD_ELEMS, generator=gen, device="cuda").to(dt)
        b = torch.randn(ADD_ELEMS, generator=gen, device="cuda").to(dt)
        out = torch.empty_like(a)
        row = {}
        names = [f"{v}{m}" for v in ADD_VARIANTS
                 for m in ("", " in place")] + ["torch.add"]
        for name in names + names[::-1]:
            if name == "torch.add":
                ms = graph_ms(lambda: torch.add(a, b, out=out), 50)
            else:
                use("fused_add", name.split(" ")[0])
                if name.endswith("in place"):
                    ms = graph_ms(lambda: rc.fused_add(out, b, out=out), 50)
                else:
                    ms = graph_ms(lambda: rc.fused_add(a, b, out=out), 50)
            row.setdefault(name, []).append(ms)
        bound = rc.work(ADD_ELEMS, a.element_size()) / HBM_BYTES_PER_S * 1e3
        add_times[str(dt).split(".")[-1]] = {"ms": row, "bound_ms": bound}
        _say(f"fused_add {dt} n={ADD_ELEMS} ms: "
             + json.dumps({k: [round(v, 4) for v in vs] for k, vs in row.items()})
             + f"; bound {bound:.4f} ms")
        del a, b, out
        torch.cuda.empty_cache()

    print(json.dumps({"peer_ring": ring_times, "peer_ring_fifo": ring_info,
                      "peer_ring_cycles_a_step": ring_profile,
                      "peer_ring_fresh_fifos": ring_spread,
                      "fused_add": add_times, "ptxas": ptxas}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
