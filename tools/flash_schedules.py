#!/usr/bin/env python3
"""Where the wgmma flash-attention kernel spends a tile, and what the
schedules it did not take would give, on one NVIDIA GPU.

    python3 tools/flash_schedules.py

1. Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as shipped
   and five variants of it, made by text substitution in its
   ``flash_fwd_wgmma``:

   * ``pingpong``: the two consumer warpgroups take turns on the tensor
     cores through named barriers (a turn issues tile j-1's O += P V and
     tile j's S = Q K^T), so that one's softmax runs while the other's
     products do; a 3-stage K/V ring at head width 128;
   * ``overlap``: each consumer issues tile j's S before tile j-1's P.V
     and runs tile j's softmax while that P.V runs; a 3-stage ring;
   * ``rescale``: O rescaled after every tile, whether or not a row's max
     moved;
   * ``valid_key``: the edge tiles' mask through ``valid_key``'s three
     tests for each score, not as per-row key bounds;
   * ``first``: the kernel as first written: every tile's scores through
     ``valid_key`` (no branch of their own for the edge tiles), ``exp2f``,
     the max and the sum in one chain a row, O rescaled after every tile,
     a 2-stage ring at both widths;

   and prints what ``-Xptxas -v`` says of their spills.
2. Holds each against ``flash_attention_plain`` (the unchanged bf16
   tolerance) on ragged, windowed, non-causal and transposed-view inputs
   at head widths 64 and 128.
3. Times each at the glm4-9b layer ``[8, 32/2, 2048, 128]`` and the
   qwen2-0.5b layer ``[8, 14/2, 2048, 64]`` (causal, bf16) by CUDA-graph
   replay, in turns (shipped first, then each variant, then the order
   reversed), beside ``F.scaled_dot_product_attention``.
4. Profiles the shipped schedule with ``clock64``: the cycles a consumer
   warpgroup spends a tile waiting for its K/V stage, in S = Q K^T, in the
   softmax (with the rescale and the bf16 packing of P), and in O += P V.
5. Runs ``tools/flash_softmax_bench.cu``: the softmax alone, one and two
   warps a scheduler, beside a warpgroup that keeps the tensor cores busy,
   and 64 exponentials a call (the special-function units' pace).

Its last lines are one JSON object of every number and the card's
``nvidia-smi`` name and power limit.  It exits nonzero without CUDA or if a
variant disagrees with the plain version.
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

SHAPES = {"glm4-9b": (8, 32, 2, 2048, 128), "qwen2-0.5b": (8, 14, 2, 2048, 64)}
TOL = (2e-2, 1.6e-2)          # the flash kernel's bf16 tolerance

RESCALE = """#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        o[4 * i + 0] *= al_a;
        o[4 * i + 1] *= al_a;
        o[4 * i + 2] *= al_b;
        o[4 * i + 3] *= al_b;
      }
"""
# the shipped loop, from the wait for Q to the loop's end
LOOP_HEAD = "  mbar_wait(q_full, 0);\n  for (int j = 0; j < n; ++j) {\n"
LOOP_TAIL = "    if (lane == 0) mbar_arrive(&empty[s]);\n  }\n"
SERIAL_STAGES = "static constexpr int kStages = HD == 128 ? 2 : 4;"
DEEP_STAGES = "static constexpr int kStages = HD == 128 ? 3 : 4;"

PINGPONG = """  if (wg == 1) named_arrive(1, 256);
  mbar_wait(q_full, 0);
  for (int j = 0; j <= n; ++j) {
    const int s = j % kStages;
    if (j < n) mbar_wait(&full[s], (j / kStages) & 1);
    named_sync(1 + wg, 256);
    if (j > 0) {
      const int prev = (j - 1) % kStages;
      wgmma_fence();
      pv_issue<HD>(o, pa, v_base + prev * T::kTileBytes);
      wgmma_wait<0>();
      reg_fence(o);
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    if (j < n) {
      wgmma_fence();
      qk_issue<HD>(sc, q_base, k_base + s * T::kTileBytes);
    }
    if (wg == 0 || j < n) named_arrive(2 - wg, 256);
    if (j < n) {
      wgmma_wait<0>();
      reg_fence(sc);
      online_softmax(sc, p, (kt_lo + j) * BK, w0, row_a, row_b, t, m_a, m_b,
                     l_a, l_b, al_a, al_b);
""" + RESCALE + """      to_fragments(sc, pa);
    }
  }
"""
NAMED_BARRIERS = """__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {"""
OVERLAP = """  mbar_wait(q_full, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  qk_issue<HD>(sc, q_base, k_base);
  wgmma_wait<0>();
  reg_fence(sc);
  online_softmax(sc, p, kt_lo * BK, w0, row_a, row_b, t, m_a, m_b, l_a, l_b,
                 al_a, al_b);
  to_fragments(sc, pa);
  for (int j = 1; j < n; ++j) {
    const int s = j % kStages, prev = (j - 1) % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    wgmma_fence();
    qk_issue<HD>(sc, q_base, k_base + s * T::kTileBytes);
    pv_issue<HD>(o, pa, v_base + prev * T::kTileBytes);
    wgmma_wait<1>();
    reg_fence(sc);
    online_softmax(sc, p, (kt_lo + j) * BK, w0, row_a, row_b, t, m_a, m_b,
                   l_a, l_b, al_a, al_b);
    wgmma_wait<0>();
    reg_fence(o);
    if (lane == 0) mbar_arrive(&empty[prev]);
""" + RESCALE + """    to_fragments(sc, pa);
  }
  wgmma_fence();
  pv_issue<HD>(o, pa, v_base + ((n - 1) % kStages) * T::kTileBytes);
  wgmma_wait<0>();
  reg_fence(o);
  if (lane == 0) mbar_arrive(&empty[(n - 1) % kStages]);
"""
BOUNDS_MASK = """        const bool ok =
            e < 2 ? kp >= lo_a && kp <= hi_a : kp >= lo_b && kp <= hi_b;
        sc[4 * j + e] = ok ? sc[4 * j + e] * scale : kNegBig;"""
VALID_KEY_MASK = """        const int qp = e < 2 ? row_a : row_b;
        sc[4 * j + e] =
            valid_key(qp, kp, p) ? sc[4 * j + e] * scale : kNegBig;"""
FIRST_SOFTMAX = """// The softmax as first written (tools/flash_schedules.py, variant "first")
__device__ __forceinline__ void online_softmax(float (&sc)[64], const Params& p,
                                               int k0, int w0, int row_a,
                                               int row_b, int t, float& m_a,
                                               float& m_b, float& l_a,
                                               float& l_b, float& al_a,
                                               float& al_b) {
  constexpr int BK = 128;
  const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > w0) ||
                    (p.window && w0 + 15 - k0 >= p.window);
  float mx_a = kNegBig, mx_b = kNegBig;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = k0 + 8 * j + 2 * t + (e & 1);
      const int qp = e < 2 ? row_a : row_b;
      const float x = !edge || valid_key(qp, kp, p)
                          ? sc[4 * j + e] * p.scale_log2 : kNegBig;
      sc[4 * j + e] = x;
      if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  al_a = exp2f(m_a - mn_a);
  al_b = exp2f(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j + 0] = exp2f(sc[4 * j + 0] - mn_a);
    sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn_a);
    sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn_b);
    sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn_b);
    rs_a += sc[4 * j + 0] + sc[4 * j + 1];
    rs_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
  }
  l_a = l_a * al_a + rs_a;
  l_b = l_b * al_b + rs_b;
}

"""
PROF_TAIL = """
extern "C" int flash_prof(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(unsigned long long) * 8);
  if (reset) {
    const unsigned long long z[8] = {0};
    cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)e;
}
"""


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise AssertionError(f"the kernel source no longer holds, once: {old[:70]!r}")
    return text.replace(old, new)


def _loop(base: str):
    a = base.index(LOOP_HEAD)
    b = base.index(LOOP_TAIL, a) + len(LOOP_TAIL)
    return a, b


def variants(base: str) -> dict:
    """The shipped source and its schedule variants, by name."""
    a, b = _loop(base)
    loop = base[a:b]
    cond = loop[loop.index("    // rescale only where"):loop.index("    to_fragments(sc, pa);")]
    out = {"shipped": base}
    pp = base[:a] + PINGPONG + base[b:]
    pp = _sub(pp, "__device__ __forceinline__ void wgmma_fence() {", NAMED_BARRIERS)
    out["pingpong"] = _sub(pp, SERIAL_STAGES, DEEP_STAGES)
    out["overlap"] = _sub(base[:a] + OVERLAP + base[b:], SERIAL_STAGES, DEEP_STAGES)
    every_tile = "\n".join(line[2:] if line.startswith("  ") else line
                           for line in RESCALE.split("\n"))
    out["rescale"] = base[:a] + loop.replace(cond, every_tile) + base[b:]
    out["valid_key"] = _sub(base, BOUNDS_MASK, VALID_KEY_MASK)
    first = out["rescale"]
    f0 = first.index("// One thread's rows of the online softmax over a tile")
    f1 = first.index("// P in bf16: the A fragments of the P.V product")
    first = first[:f0] + FIRST_SOFTMAX + first[f1:]
    out["first"] = _sub(first, SERIAL_STAGES,
                        "static constexpr int kStages = 2;")
    return out


def profiled(base: str) -> str:
    """The shipped source with clock64 phase counters in its consumers."""
    t = base.replace("namespace {\n", "__device__ unsigned long long g_prof[8];\n"
                     "namespace {\n", 1) + PROF_TAIL
    t = _sub(t, LOOP_HEAD, """  long long c_w = 0, c_s = 0, c_sm = 0, c_pv = 0, t0, t1;
  mbar_wait(q_full, 0);
  for (int j = 0; j < n; ++j) {
    t0 = clock64();
""")
    t = _sub(t, "    mbar_wait(&full[s], (j / kStages) & 1);\n    wgmma_fence();\n",
             "    mbar_wait(&full[s], (j / kStages) & 1);\n"
             "    t1 = clock64(); c_w += t1 - t0; t0 = t1;\n    wgmma_fence();\n")
    t = _sub(t, "    reg_fence(sc);\n    online_softmax(",
             "    reg_fence(sc);\n    t1 = clock64(); c_s += t1 - t0; t0 = t1;\n"
             "    online_softmax(")
    t = _sub(t, "    to_fragments(sc, pa);\n    wgmma_fence();\n    pv_issue",
             "    to_fragments(sc, pa);\n    t1 = clock64(); c_sm += t1 - t0; t0 = t1;\n"
             "    wgmma_fence();\n    pv_issue")
    t = _sub(t, LOOP_TAIL, """    t1 = clock64(); c_pv += t1 - t0;
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (tid == 0) {
    atomicAdd(&g_prof[0], (unsigned long long)c_w);
    atomicAdd(&g_prof[1], (unsigned long long)c_s);
    atomicAdd(&g_prof[2], (unsigned long long)c_sm);
    atomicAdd(&g_prof[3], (unsigned long long)c_pv);
    atomicAdd(&g_prof[4], (unsigned long long)n);
  }
""")
    return t


def main() -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_schedules: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import _graph_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    base = (build.CSRC / "flash_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "flash_schedules"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()

    def compile_lib(name: str, src_path):
        lib_path = out_dir / f"{name}.so"
        cmd = build.nvcc_command("flash_attention", lib_path, nvcc)
        cmd[-1] = str(src_path)
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
        spills, kernel = {}, None
        for line in (r.stdout + r.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = ("hd128" if "wgmmaILi128" in m.group(1) else
                          "hd64" if "wgmmaILi64" in m.group(1) else None)
            elif kernel and "spill stores" in line:
                spills[kernel] = int(line.split("bytes spill stores")[0].split(",")[-1])
        return ctypes.CDLL(str(lib_path)), spills

    libs, spills = {}, {}
    sources = dict(variants(base), profiled=profiled(base))
    for name, text in sources.items():
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        libs[name], spills[name] = compile_lib(name, path)
        print(f"[flash_schedules] built {name}: spill stores {spills[name]}",
              flush=True)

    def use(name: str) -> None:
        build._libs["flash_attention"] = libs[name]
        fa._lib()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def inputs(B, H, KV, S, hd, view=False):
        shapes = ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)) if view else \
            ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))
        xs = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
              for s in shapes]
        return [x.transpose(1, 2) for x in xs] if view else xs

    worst = {}
    cases = [(c, hd) for hd in (64, 128) for c in (
        ((1, 4, 2, 130), dict(block_q=130, block_k=130)),
        ((2, 2, 1, 200), dict(causal=False, window=70, block_q=200, block_k=200)),
        ((1, 4, 2, 256), dict(window=70)),
        ((2, 8, 2, 192), dict(block_q=64, block_k=64, view=True)),
        ((1, 2, 2, 1000), dict(window=300, block_q=8, block_k=8)))]
    for (dims, kw), hd in cases:
        kw = dict(kw)
        q, k, v = inputs(*dims, hd, view=kw.pop("view", False))
        want = fa.flash_attention_plain(q, k, v, **kw).float()
        for name in libs:
            use(name)
            got = fa.flash_attention(q, k, v, **kw).float()
            err = (got - want).abs()
            if not bool((err <= TOL[0] + TOL[1] * want.abs()).all()):
                raise AssertionError(f"{name} disagrees with the plain version "
                                     f"on {dims} hd {hd} {kw}")
            worst[name] = max(worst.get(name, 0.0), err.max().item())
    print(f"[flash_schedules] every variant == plain (max abs err {worst})",
          flush=True)

    times, profile = {}, {}
    order = [n for n in libs if n != "profiled"]
    for label, (B, H, KV, S, hd) in SHAPES.items():
        q, k, v = inputs(B, H, KV, S, hd)
        row = {}
        for name in order + order[::-1]:
            use(name)
            row.setdefault(name, []).append(
                _graph_ms(lambda: fa.flash_attention(q, k, v), 10))
        row["sdpa"] = [_graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10)]
        times[label] = row
        print(f"[flash_schedules] {label} [{B},{H}/{KV},{S},{hd}] ms: "
              + json.dumps({n: [round(t, 4) for t in ts] for n, ts in row.items()}),
              flush=True)
        use("profiled")
        buf = (ctypes.c_ulonglong * 8)()
        fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        libs["profiled"].flash_prof(buf, 1)
        fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        libs["profiled"].flash_prof(buf, 1)
        tiles = buf[4]
        profile[label] = {key: buf[i] / tiles for i, key in enumerate(
            ("wait", "s_product", "softmax", "pv_product"))}
        print(f"[flash_schedules] {label} cycles a consumer warpgroup-tile: "
              + json.dumps({k: round(v) for k, v in profile[label].items()}),
              flush=True)
        del q, k, v

    bench_path = out_dir / "softmax_bench.so"
    cmd = build.nvcc_command("flash_attention", bench_path, nvcc)
    cmd[-1] = os.path.join(ROOT, "tools", "flash_softmax_bench.cu")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the softmax bench:\n{r.stdout}{r.stderr}")
    bench = ctypes.CDLL(str(bench_path))
    bench.run_softmax_bench.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 3
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    outb = torch.zeros(n_sm * 256, device="cuda")
    cyc = torch.zeros(n_sm, dtype=torch.int64, device="cuda")
    softmax, iters = {}, 300
    for mode, label in ((0, "alone"), (1, "two warps a scheduler"),
                        (2, "beside S = Q K^T products"),
                        (3, "beside O += P V products"),
                        (4, "64 exponentials, alone")):
        for _ in range(2):
            err = bench.run_softmax_bench(outb.data_ptr(), cyc.data_ptr(), n_sm,
                                          iters, mode)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"softmax bench launch failed: CUDA error {err}")
        softmax[label] = cyc.float().mean().item() / iters
        print(f"[flash_schedules] softmax {label}: {softmax[label]:.0f} cycles "
              f"a call (64 FMAs included)", flush=True)

    print(json.dumps({"times_ms": times, "cycles_a_warpgroup_tile": profile,
                      "softmax_cycles_a_call": softmax, "spill_stores": spills,
                      "max_abs_err": worst}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
