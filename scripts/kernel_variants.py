"""Time variants of kernels K2 (G1 bucket scan), K3 (grouping sort) and
K4 (G2 bucket scan) on one NVIDIA card.

    python3 scripts/kernel_variants.py [K1] [K2] [K3] [K4] [K5]

(all five when none is named).  A variant is the kernel's source in this
checkout with a few text edits: a register cap, the number of sub-lanes,
a Montgomery product written with PTX carry chains, the keys per thread;
for K4 also the Fp2 product inlined, with its three Karatsuba products
interleaved in one CIOS loop, or reading the modulus through the kernel
parameter's address or from the stack instead of from __constant__
memory, the combine through shared memory instead of warp shuffles, the
shared-memory carveout, a persistent grid of fewer warps.  The script builds
every variant with the flags of zikkurat_algebra_tpu_torch/utils/build.py
(one nvcc per variant, all started together) into build/variants/, prints
the registers, spills and stack frames ptxas reports, and runs each on
the BLS12-381 path's inputs at 2^20 (the committed seeds tiled, random
scalars, block 512) as chip_smoke.py gives them to the kernel: the G1
path's for K2 and K3, the G2 path's for K4.  Each variant is checked
against the committed kernel (K2's and K4's buckets and trailers as
points after `to_affine`, K3 exactly) and timed with CUDA events; the
committed kernel runs first and last.  K1 (Montgomery
product, 2^20 elements at each width it takes; a variant with four
elements and 16-byte loads per thread at W <= 4) and K5 (a 2^20 radix-2
NTT of BLS12-381 Fr and of goldilocks in the passes of `pass_plan` for the
variant's tile; variants of the tile's shared memory, the threads per CTA
and the register cap) are checked against the committed kernel limb for
limb and timed by CUDA events and by device time (`chip_smoke.graph_ms`
on one copy of the data: a CUDA graph of 20 calls back to back).
The last line is a JSON object with every number, the line before it the
card's name and power limit.
It needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# r = a b R^-1 mod p with PTX carry chains (mad.lo.cc / madc.hi.cc): the
# low and the high halves of a[j] b[i], then of m p[j], each added along
# one carry chain.  Same contract as zk::mont_mul in csrc/field.cuh.
MONT_MUL_CC = r"""
#pragma once
namespace zk {
template <int W>
__device__ __forceinline__ void mont_mul_cc(uint32_t (&r)[W],
                                            const uint32_t (&a)[W],
                                            const uint32_t (&b)[W],
                                            const uint32_t (&p)[W],
                                            uint32_t n0) {
  uint32_t t[W + 2];
#pragma unroll
  for (int i = 0; i < W + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t bi = b[i];
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(a[0]), "r"(bi));
#pragma unroll
    for (int j = 1; j < W; ++j)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(a[j]), "r"(bi));
    asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(t[W]));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[W + 1]));
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(a[0]), "r"(bi));
#pragma unroll
    for (int j = 1; j < W; ++j)
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(a[j]), "r"(bi));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[W + 1]));
    const uint32_t m = t[0] * n0;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(m), "r"(p[0]));
#pragma unroll
    for (int j = 1; j < W; ++j)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(m), "r"(p[j]));
    asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(t[W]));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[W + 1]));
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(m), "r"(p[0]));
#pragma unroll
    for (int j = 1; j < W; ++j)
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(m), "r"(p[j]));
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[W + 1]));
#pragma unroll
    for (int j = 0; j <= W; ++j) t[j] = t[j + 1];
    t[W + 1] = 0u;
  }
  uint32_t lo[W];
#pragma unroll
  for (int i = 0; i < W; ++i) lo[i] = t[i];
  reduce_once<W>(r, lo, t[W], p);
}
}  // namespace zk
"""

K2_BOUNDS = "__launch_bounds__(kThreads, 12)"
CC = [("zk::mont_mul<W>", "zk::mont_mul_cc<W>"),
      ('#include "field.cuh"', '#include "field.cuh"\n#include "mont_cc.cuh"')]
K2_VARIANTS = {
    "no register cap (255)": [(K2_BOUNDS, "__launch_bounds__(kThreads)")],
    "128 registers": [(K2_BOUNDS, "__launch_bounds__(kThreads, 16)")],
    "4 sub-lanes": [("constexpr int kSub = 8;", "constexpr int kSub = 4;")],
    "16 sub-lanes": [("constexpr int kSub = 8;", "constexpr int kSub = 16;")],
    "PTX carry chains": CC,
    "PTX carry chains, no register cap": CC + [
        (K2_BOUNDS, "__launch_bounds__(kThreads)")],
}
# K4's Fp2 product with its three Karatsuba products interleaved in one
# CIOS loop: three independent carry chains per row.  Same contract as
# zk::f2_mul in csrc/field.cuh.
F2_MUL_IL = r"""
#pragma once
namespace zk {
template <int W>
__device__ __forceinline__ void cios_row(uint32_t (&t)[W + 2],
                                         const uint32_t (&a)[W], uint32_t bi,
                                         const uint32_t (&p)[W], uint32_t n0) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint64_t s = static_cast<uint64_t>(a[j]) * bi + t[j] + c;
    t[j] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  uint64_t s = static_cast<uint64_t>(t[W]) + c;
  t[W] = static_cast<uint32_t>(s);
  t[W + 1] = static_cast<uint32_t>(s >> 32);
  const uint32_t m = t[0] * n0;
  s = static_cast<uint64_t>(m) * p[0] + t[0];
  c = s >> 32;
#pragma unroll
  for (int j = 1; j < W; ++j) {
    s = static_cast<uint64_t>(m) * p[j] + t[j] + c;
    t[j - 1] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  s = static_cast<uint64_t>(t[W]) + c;
  t[W - 1] = static_cast<uint32_t>(s);
  t[W] = t[W + 1] + static_cast<uint32_t>(s >> 32);
}

template <int W>
__device__ __forceinline__ void f2_mul_il(Fp2<W>& r, const Fp2<W>& a,
                                       const Fp2<W>& b,
                                       const uint32_t (&p)[W], uint32_t n0,
                                       int qnr) {
  uint32_t sa[W], sb[W], t0[W + 2], t1[W + 2], t2[W + 2];
  add_mod<W>(sa, a.c0, a.c1, p);
  add_mod<W>(sb, b.c0, b.c1, p);
#pragma unroll
  for (int i = 0; i < W + 2; ++i) t0[i] = t1[i] = t2[i] = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    cios_row<W>(t0, a.c0, b.c0[i], p, n0);
    cios_row<W>(t1, a.c1, b.c1[i], p, n0);
    cios_row<W>(t2, sa, sb[i], p, n0);
  }
  uint32_t u0[W], u1[W], u2[W], lo[W];
#pragma unroll
  for (int i = 0; i < W; ++i) lo[i] = t0[i];
  reduce_once<W>(u0, lo, t0[W], p);
#pragma unroll
  for (int i = 0; i < W; ++i) lo[i] = t1[i];
  reduce_once<W>(u1, lo, t1[W], p);
#pragma unroll
  for (int i = 0; i < W; ++i) lo[i] = t2[i];
  reduce_once<W>(u2, lo, t2[W], p);
  add_mod<W>(lo, u0, u1, p);
  sub_mod<W>(r.c1, u2, lo, p);
  mul_nr<W>(u1, u1, qnr, p);
  add_mod<W>(r.c0, u0, u1, p);
}
}  // namespace zk
"""

# K4's combine through a shared buffer instead of warp shuffles: limb i of
# coordinate c of lane l at [(c W + i) 32 + l] (one warp per CTA).
K4_SHFL = """#pragma unroll
  for (int i = 0; i < W; ++i) {
    X2.c0[i] = __shfl_up_sync(kFull, X.c0[i], j, kSub);
    X2.c1[i] = __shfl_up_sync(kFull, X.c1[i], j, kSub);
    Y2.c0[i] = __shfl_up_sync(kFull, Y.c0[i], j, kSub);
    Y2.c1[i] = __shfl_up_sync(kFull, Y.c1[i], j, kSub);
    Z2.c0[i] = __shfl_up_sync(kFull, Z.c0[i], j, kSub);
    Z2.c1[i] = __shfl_up_sync(kFull, Z.c1[i], j, kSub);
  }"""
K4_SHARED = """__shared__ uint32_t sh[6 * W * 32];
  const int lane = threadIdx.x & 31;
  const int q = (lane & (kSub - 1)) >= j ? lane - j : lane;
  const uint32_t* src[6] = {X.c0, X.c1, Y.c0, Y.c1, Z.c0, Z.c1};
  uint32_t* dst[6] = {X2.c0, X2.c1, Y2.c0, Y2.c1, Z2.c0, Z2.c1};
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int i = 0; i < W; ++i) sh[(c * W + i) * 32 + lane] = src[c][i];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int i = 0; i < W; ++i) dst[c][i] = sh[(c * W + i) * 32 + q];"""
# K4's called Fp2 product reading the modulus through the address of the
# kernel parameter (generic loads) instead of from __constant__ memory.
F2_MUL_PARAM = r"""
#pragma once
namespace zk {
template <int W>
__device__ __noinline__ void f2_mul_param(Fp2<W>& r, const Fp2<W>& a,
                                          const Fp2<W>& b,
                                          const uint32_t (&p)[W], uint32_t n0,
                                          int qnr) {
  f2_mul<W>(r, a, b, p, n0, qnr);
}
}  // namespace zk
"""

# A persistent K4: Q one-warp CTAs per SM walk the blocks' warps in a
# grid-stride loop, so fewer stack frames compete for L1.
PERSISTENT = r"""
#pragma once
inline unsigned persistent_grid(long long ctas, int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long g = static_cast<long long>(sms) * per_sm;
  return static_cast<unsigned>(ctas < g ? ctas : g);
}
"""
K4_CARVEOUT = "kCarveoutPercent = 8;"
K4_BOUNDS = "__launch_bounds__(kThreads, 12)"
K4_INCLUDE = '#include "field.cuh"'
MOD_PARAM = [
    ("f2_mul_called<W>(r, a, b, k.n0, k.qnr);",
     "zk::f2_mul_param<W>(r, a, b, k.p, k.n0, k.qnr);"),
    (K4_INCLUDE, K4_INCLUDE + '\n#include "f2_mul_param.cuh"')]
K4_CALLED = "__device__ __noinline__ void f2_mul_called"
K4_INLINED = "__device__ __forceinline__ void f2_mul_called"


def persistent(q):
    return [
        ("  const long long g = static_cast<long long>(blockIdx.x) * "
         "blockDim.x +\n                      threadIdx.x;",
         "  const long long total = static_cast<long long>(nwin) * nblk * "
         "kSub;\n  for (long long g0 = static_cast<long long>(blockIdx.x) * "
         "blockDim.x;\n       g0 < total; g0 += static_cast<long long>("
         "gridDim.x) * blockDim.x) {\n  const long long g = g0 + "
         "threadIdx.x;"),
        ("    zk::store_fp2<W>(bz, Z, e, bstride);\n  }\n}\n\nlong long ctas(",
         "    zk::store_fp2<W>(bz, Z, e, bstride);\n  }\n  }\n}\n\n"
         "long long ctas("),
        ("bucket_scan2_kernel<W><<<static_cast<unsigned>(ctas(nwin, n, m)),",
         f"bucket_scan2_kernel<W><<<persistent_grid(ctas(nwin, n, m), {q}),"),
        (K4_INCLUDE + "\n", K4_INCLUDE + '\n#include "persistent.cuh"\n'),
        (K4_BOUNDS, "__launch_bounds__(kThreads)")]


K4_VARIANTS = {
    "2 sub-lanes": [("constexpr int kSub = 4;", "constexpr int kSub = 2;")],
    "8 sub-lanes": [("constexpr int kSub = 4;", "constexpr int kSub = 8;")],
    "16 sub-lanes": [("constexpr int kSub = 4;", "constexpr int kSub = 16;")],
    "no register cap (255)": [(K4_BOUNDS, "__launch_bounds__(kThreads)")],
    "128 registers": [(K4_BOUNDS, "__launch_bounds__(kThreads, 16)")],
    "Fp2 product inlined": [(K4_CALLED, K4_INLINED)],
    "Fp2 product inlined, no register cap": [
        (K4_CALLED, K4_INLINED), (K4_BOUNDS, "__launch_bounds__(kThreads)")],
    "Karatsuba products interleaved in one CIOS loop": [
        ("zk::f2_mul<W>(r, a, b, modulus<W>(), n0, qnr);",
         "zk::f2_mul_il<W>(r, a, b, modulus<W>(), n0, qnr);"),
        (K4_INCLUDE, K4_INCLUDE + '\n#include "f2_mul_il.cuh"')],
    "combine through shared memory": [
        (K4_SHFL, K4_SHARED), (K4_CARVEOUT, "kCarveoutPercent = 50;")],
    "modulus through the kernel parameter's address": MOD_PARAM,
    "modulus copied to the stack": MOD_PARAM + [
        ("__grid_constant__ const Consts<W> k", "const Consts<W> k")],
    "carveout 0 (largest L1)": [(K4_CARVEOUT, "kCarveoutPercent = 0;")],
    "no carveout preference": [
        (K4_CARVEOUT, "kCarveoutPercent = cudaSharedmemCarveoutDefault;")],
    "persistent, 4 CTAs per SM, 255 registers": persistent(4),
    "persistent, 6 CTAs per SM, 255 registers": persistent(6),
    "persistent, 8 CTAs per SM, 255 registers": persistent(8),
}
K3_PASS = "__launch_bounds__(kThreads, 4)\npass_kernel("
K3_VARIANTS = {
    "no register cap": [(K3_PASS, "__launch_bounds__(kThreads)\npass_kernel(")],
    "11 keys per thread": [("constexpr int kPerThread = 15;",
                            "constexpr int kPerThread = 11;")],
    "19 keys per thread": [("constexpr int kPerThread = 15;",
                            "constexpr int kPerThread = 19;")],
}


# K5: the threads of a CTA and the CTAs the register cap leaves room
# for, per width, and the tile, a launch argument (K5_TILES: log2 of its
# elements, by W, where a variant changes it).  The pass plan follows the
# tile.
C8 = "static constexpr int kThreads = 256, kMinCtas = 3;"
C2 = "static constexpr int kThreads = 1024, kMinCtas = 1;"
R8 = "static constexpr int kRadixLog = 1;   // stages a thread runs per round"
R2 = "static constexpr int kRadixLog = 3;\n};"


def cfg(line, threads, ctas):
    return [(line, f"static constexpr int kThreads = {threads}, kMinCtas = "
                   f"{ctas};")]


# Variants named "ablation: ..." compute something else on purpose: they
# are timed, not checked, to split the kernel's time into its parts.
K5_VARIANTS = {
    "W=8: 2 stages per round": [(R8, "static constexpr int kRadixLog = 2;")],
    "W=8: 2 stages per round, 2 CTAs": [
        (R8, "static constexpr int kRadixLog = 2;")] + cfg(C8, 256, 2),
    "W=8: 2 stages per round, 128 threads, 4 CTAs": [
        (R8, "static constexpr int kRadixLog = 2;")] + cfg(C8, 128, 4),
    "W=8: 32 KB tiles, 256 threads, 4 CTAs": cfg(C8, 256, 4),
    "W=8: 64 KB tiles, 256 threads, 3 CTAs": [],
    "W=2: 1 stage per round": [(R2, "static constexpr int kRadixLog = 1;\n};")],
    "W=2: 2 stages per round": [(R2, "static constexpr int kRadixLog = 2;\n};")],
    "W=2: 4 stages per round": [(R2, "static constexpr int kRadixLog = 4;\n};")],
    "W=2: 64 KB tiles, 512 threads, 1 CTA": cfg(C2, 512, 1),
    "W=2: 32 KB tiles, 512 threads, 2 CTAs": cfg(C2, 512, 2),
    "W=2: 16 KB tiles, 256 threads, 4 CTAs": cfg(C2, 256, 4),
    "ablation: no products": [
        ("  if (!unit) zk::mont_mul<W>(v, v, w, p, n0);",
         "  if (!unit) v[0] ^= w[0];")],
    "ablation: loads and stores only": [
        ("  rounds<W, Cfg<W>::kRadixLog>(sm, tile, tabs, p, n0, unit1, 0, k,",
         "  rounds<W, Cfg<W>::kRadixLog>(sm, tile, tabs, p, n0, unit1, k, k,")],
}
K5_TILES = {"W=8: 64 KB tiles, 256 threads, 3 CTAs": {8: 11},
            "W=2: 32 KB tiles, 512 threads, 2 CTAs": {2: 12},
            "W=2: 16 KB tiles, 256 threads, 4 CTAs": {2: 11}}
# K1 at W <= 4: four consecutive elements per thread, one 16-byte load or
# store per limb plane, a scalar tail for n mod 4 (W = 1; wider planes
# take the vector path only when n mod 4 = 0, so that every plane is
# 16-byte aligned).
K1_VEC_KERNEL = r"""
template <int W>
__global__ void __launch_bounds__(256)
mont_mul4_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, const int32_t* __restrict__ pp,
                 uint32_t n0, long long n) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  uint32_t p[W], x[W], y[W], r[W];
#pragma unroll
  for (int i = 0; i < W; ++i) p[i] = static_cast<uint32_t>(__ldg(pp + i));
  if (q < (n >> 2)) {
    int4 va[W], vb[W], vo[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      va[i] = __ldg(reinterpret_cast<const int4*>(a + i * n) + q);
      vb[i] = __ldg(reinterpret_cast<const int4*>(b + i * n) + q);
    }
#define ZK_LANE(c)                                                       \
  for (int i = 0; i < W; ++i) {                                          \
    x[i] = static_cast<uint32_t>(va[i].c);                               \
    y[i] = static_cast<uint32_t>(vb[i].c);                               \
  }                                                                      \
  zk::mont_mul<W>(r, x, y, p, n0);                                       \
  for (int i = 0; i < W; ++i) vo[i].c = static_cast<int32_t>(r[i]);
    ZK_LANE(x) ZK_LANE(y) ZK_LANE(z) ZK_LANE(w)
#undef ZK_LANE
#pragma unroll
    for (int i = 0; i < W; ++i) reinterpret_cast<int4*>(out + i * n)[q] = vo[i];
  }
  const long long e = ((n >> 2) << 2) + q;   // the tail, n mod 4 elements
  if (q < (n & 3)) {
    zk::load_limbs<W>(x, a, e, n);
    zk::load_limbs<W>(y, b, e, n);
    zk::mont_mul<W>(r, x, y, p, n0);
    zk::store_limbs<W>(out, r, e, n);
  }
}

template <int W>
cudaError_t launch(const int32_t* a, const int32_t* b, int32_t* out,"""
K1_VEC_LAUNCH = r"""  const int threads = 256;
  const auto al = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  if (W <= 4 && al(a) && al(b) && al(out) && (W == 1 || (n & 3) == 0)) {
    const long long quads = (n >> 2) > 0 ? (n >> 2) : 1;
    mont_mul4_kernel<W><<<static_cast<unsigned>((quads + threads - 1) /
                                                threads),
                          threads, 0, stream>>>(a, b, out, p, n0, n);
    return cudaGetLastError();
  }
  const long long blocks"""
K1_VARIANTS = {
    "W <= 4: 4 elements per thread, 16-byte loads": [
        ("\ntemplate <int W>\ncudaError_t launch(const int32_t* a, const "
         "int32_t* b, int32_t* out,", K1_VEC_KERNEL),
        ("  const int threads = 256;\n  const long long blocks",
         K1_VEC_LAUNCH)],
}

KERNELS = {"K2": ("block_scan", K2_VARIANTS), "K3": ("sort", K3_VARIANTS),
           "K4": ("block_scan2", K4_VARIANTS),
           "K5": ("ntt_stage", K5_VARIANTS), "K1": ("mont_mul", K1_VARIANTS)}


def build_all(build, kernels):
    """Write and compile every variant of the named kernels; {(kernel,
    name): (library, ptxas report)} for those that built."""
    import chip_smoke as cs

    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mont_cc.cuh").write_text(MONT_MUL_CC)
    (out / "f2_mul_il.cuh").write_text(F2_MUL_IL)
    (out / "f2_mul_param.cuh").write_text(F2_MUL_PARAM)
    (out / "persistent.cuh").write_text(PERSISTENT)
    jobs = {}
    for kernel in kernels:
        src, variants = KERNELS[kernel]
        text = (build.CSRC / f"{src}.cu").read_text()
        for i, (name, edits) in enumerate([("committed", [])]
                                          + list(variants.items())):
            s = text
            for a, b in edits:
                if a not in s:
                    raise RuntimeError(f"{kernel} {name}: {a!r} not in {src}.cu")
                s = s.replace(a, b)
            f = out / f"{src}_{i}.cu"
            f.write_text(s)
            jobs[(kernel, name)] = f
    nvcc = build.find_nvcc()
    procs = {}
    for key, f in jobs.items():
        with open(f.with_suffix(".log"), "w") as log:
            procs[key] = subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-I",
                 str(out), "-o", str(f.with_suffix(".so")), str(f)],
                stdout=log, stderr=subprocess.STDOUT)
    built = {}
    for key, proc in procs.items():
        rc = proc.wait()
        log = jobs[key].with_suffix(".log").read_text()
        if rc:
            print(f"# {key[0]} {key[1]}: build failed\n{log[-2000:]}")
            continue
        built[key] = (ctypes.CDLL(str(jobs[key].with_suffix(".so"))),
                      cs.ptxas_report(log))
    return built


def k1_cases(dev, rng):
    """{case: (make, check)} for K1 on 2^20 elements of a field of each
    width it takes; make(lib, variant) gives the call and {}."""
    import torch
    import chip_smoke as cs
    from zikkurat_algebra_tpu_torch.ops import kernel_field
    from zikkurat_algebra_tpu_torch.ops.field import Field

    n, cases = 1 << 20, {}
    for prm in cs.k1_fields():
        f = Field(prm, dev)
        if f"W={f.W}" in cases:
            continue
        a, b = (torch.from_numpy(cs.rand_canonical(rng, f.p, f.W, n)).to(dev)
                for _ in range(2))
        want = kernel_field.mont_mul(a, b, f)

        def make(lib, variant, f=f, a=a, b=b):
            fn = lib.zk_mont_mul
            fn.argtypes, fn.restype = kernel_field._ARGTYPES, ctypes.c_int
            out = torch.empty_like(a)

            def call():
                rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        f.p32.data_ptr(), f.n0, f.W, n,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
                return out
            return call, {"W": f.W, "field": f.params.name}

        cases[f"W={f.W}"] = (make, lambda got, want=want: cs.max_limb_diff(
            got, want))
    return cases


def k5_cases(dev, rng):
    """{case: (make, check)} for K5 over a 2^20 radix-2 transform of
    BLS12-381 Fr (W = 8) and goldilocks (W = 2), the rows already in
    bit-reversed order, in the passes of `pass_plan` for the variant's
    tile; make(lib, variant) gives the call and its plan, CTAs per SM and
    shared memory per CTA."""
    import torch
    import chip_smoke as cs
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops import kernel_ntt
    from zikkurat_algebra_tpu_torch.ops.field import Field
    from zikkurat_algebra_tpu_torch.ops.ntt import NTTDomain

    m, cases = 20, {}
    for prm in (P.BLS12_381_FR, P.TEST_PRIMES["goldilocks"]):
        f = Field(prm, dev)
        tables = NTTDomain(f, m).tables()
        y0 = torch.from_numpy(cs.rand_canonical(rng, f.p, f.W, 1 << m)).to(
            dev).reshape(f.W, 1, 1 << m, 1)
        want = y0.clone()
        for s0, k in kernel_ntt.pass_plan(m, 0, kernel_ntt.tile_log(f.W)):
            kernel_ntt.ntt_stages(want, tables, s0, k, f)

        def make(lib, variant, f=f, tables=tables, y0=y0):
            fn = lib.zk_ntt_stages
            fn.argtypes, fn.restype = kernel_ntt._ARGTYPES, ctypes.c_int
            occ = lib.zk_ntt_stages_occupancy
            occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lt = K5_TILES.get(variant, {}).get(f.W, kernel_ntt.tile_log(f.W))
            per = ctypes.c_int()
            if occ(f.W, lt, ctypes.addressof(per)):
                raise RuntimeError("zk_ntt_stages_occupancy failed")
            plan = kernel_ntt.pass_plan(m, 0, lt)
            ptrs = [(ctypes.c_void_p * k)(*(t.data_ptr()
                                            for t in tables[s0:s0 + k]))
                    for s0, k in plan]
            buf = y0.clone()

            def call():
                for (s0, k), pt in zip(plan, ptrs):
                    rc = fn(buf.data_ptr(), ctypes.addressof(pt),
                            f.p32.data_ptr(), f.one_limbs.data_ptr(), f.n0,
                            f.W, 1, m, 0, s0, k, lt,
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"launch failed: cudaError {rc}")
                return buf
            return call, {"plan": plan, "blocks_per_sm": per.value,
                          "smem_bytes_per_cta": 4 * f.W << lt}

        cases[f.params.name] = (make, lambda got, want=want: cs.max_limb_diff(
            got, want))
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops import kernel_curve, kernel_sort
    from zikkurat_algebra_tpu_torch.ops import limbs as lb
    from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
    from zikkurat_algebra_tpu_torch.utils import build

    kernels = sys.argv[1:] or list(KERNELS)
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        print(f"kernel_variants: unknown kernels {sorted(unknown)}",
              file=sys.stderr)
        return 2
    t = time.perf_counter()
    built = build_all(build, kernels)
    print(f"# {len(built)} variants built in {time.perf_counter() - t:.1f} s")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ck = CurveKernels(P.BLS12_381, dev)
    f, n, m = ck.fp, 1 << 20, 512
    rng = np.random.default_rng(20)
    results, library_ms = [], None

    paths = {}

    def path(grp):
        """The path's grouped inputs at 2^20, made once: (ops, nbuckets,
        gpts, sd, idx, scalar limbs, c)."""
        if grp in paths:
            return paths[grp]
        _, _, pts = cs.tiled_seeds(ck, grp, n, dev)
        k_limbs = torch.from_numpy(cs.rand_canonical(rng, ck.fr.p, ck.fr.W,
                                                     n)).to(dev)
        c, nbuckets, gpts, sd, idx = ck.msm(grp).group(k_limbs, pts, None, m)
        ops = ck.g1 if grp == "g1" else ck.g2
        paths[grp] = ops, nbuckets, gpts, sd, idx, k_limbs, c
        return paths[grp]

    def occupancy_of(symbol, W, nwin, nk):
        def query(lib):
            per, ctas = ctypes.c_int(), ctypes.c_longlong()
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_int] * (2 if W is None else 4) + \
                [ctypes.c_void_p] * 2
            head = (nwin, nk) if W is None else (W, nwin, nk, m)
            rc = fn(*head, ctypes.addressof(per), ctypes.addressof(ctas))
            if rc:
                raise RuntimeError(f"{symbol} failed: cudaError {rc}")
            return per.value, ctas.value
        return query

    def scan_setup(grp, symbol, argtypes, consts):
        """(make, occupancy, check) for K2 (g1) or K4 (g2) on the path's
        inputs; check compares with the committed kernel's output as
        points."""
        ops, nbuckets, gpts, sd, idx, _, _ = path(grp)
        nwin = sd.shape[0]
        ref = kernel_curve.bucket_scan(ops, *gpts, sd, idx, m, nbuckets)

        def make(lib):
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

            def call():
                b, S = kernel_curve._outputs(ops, sd, m, nbuckets)
                rc = fn(*(t.data_ptr() for t in (*gpts, sd, idx) + b + S),
                        *consts(ops), f.W, nwin, n, gpts[0].shape[-1], m,
                        nbuckets + 1, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
                return b, S
            return call

        def check(got):
            return max(cs.affine_diff(ops, g, w) for g, w in zip(got, ref))
        return make, occupancy_of(symbol + "_occupancy", f.W, nwin, n), check

    setups = {}
    if "K2" in kernels:
        setups["K2"] = scan_setup(
            "g1", "zk_bucket_scan", kernel_curve._ARGTYPES,
            lambda ops: (lb.host_words(f.p, f.W), f.n0,
                         lb.host_words(f.R % f.p, f.W), ops.b3))
    if "K3" in kernels:
        _, nbuckets, _, _, _, k_limbs, c = path("g1")
        keys = ck.msm("g1").digits(k_limbs, c, m).abs()
        wc, nk = keys.shape
        pay = torch.arange(nk, dtype=torch.int32, device=dev).expand(
            1, wc, nk).contiguous()
        want = kernel_sort.sort_key_val_plain(keys, pay)
        bits = nbuckets.bit_length()

        def k3_call(lib):
            fn = lib.zk_sort_key_val
            fn.argtypes, fn.restype = kernel_sort._ARGTYPES, ctypes.c_int
            size = lib.zk_sort_scratch_bytes
            size.argtypes, size.restype = [ctypes.c_int] * 3, \
                ctypes.c_longlong
            scratch = torch.empty(size(wc, nk, bits), dtype=torch.uint8,
                                  device=dev)
            bufs = [torch.empty_like(t) for t in (keys, pay, keys, pay)]

            def call():
                rc = fn(keys.data_ptr(), pay.data_ptr(),
                        *(t.data_ptr() for t in bufs), scratch.data_ptr(), wc,
                        nk, 1, bits, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
                return bufs[0], bufs[1]
            return call

        setups["K3"] = (k3_call, occupancy_of("zk_sort_occupancy", None, wc,
                                              nk),
                        lambda got: cs.max_limb_diff(got, want))
        library_ms = cs.time_ms(
            lambda: kernel_sort.sort_key_val_plain(keys, pay), 20, dev)
        print(f"# torch.sort(stable=True) + gather: {library_ms:.4f} ms")
    if "K4" in kernels:
        setups["K4"] = scan_setup(
            "g2", "zk_bucket_scan2", kernel_curve._ARGTYPES2,
            lambda ops: kernel_curve._fp2_consts(f, ops.b3, ck.tower.qnr))

    for kernel in [k for k in kernels if k in setups]:
        make, occupancy, check = setups[kernel]
        reps = 20 if kernel == "K3" else 3
        for name in ["committed", *KERNELS[kernel][1], "committed"]:
            if (kernel, name) not in built:
                continue
            lib, ptxas = built[(kernel, name)]
            call = make(lib)
            err = check(call())
            ms = cs.time_ms(call, reps, dev)
            per_sm, ctas = occupancy(lib)
            row = dict(kernel=kernel, variant=name, ms=ms, max_abs_err=err,
                       blocks_per_sm=per_sm, ctas=ctas,
                       waves=ctas / (per_sm * sms) if per_sm else None,
                       ptxas=cs.ptxas_rows(ptxas))
            results.append(row)
            print(f"# {kernel} {name}: {ms:.4f} ms, max |diff| {err}, "
                  f"{per_sm} CTAs per SM, {row['waves']} waves; ptxas "
                  + cs.ptxas_text(ptxas), flush=True)
            if err:
                raise AssertionError(f"{kernel} {name} differs from the "
                                     "committed kernel")
    for kernel in [k for k in ("K1", "K5") if k in kernels]:
        cases = k1_cases(dev, rng) if kernel == "K1" else k5_cases(dev, rng)
        for name in ["committed", *KERNELS[kernel][1], "committed"]:
            if (kernel, name) not in built:
                continue
            lib, ptxas = built[(kernel, name)]
            for case, (make, check) in cases.items():
                call, extra = make(lib, name)
                err = check(call())
                ms = cs.time_ms(call, 20, dev)
                dev_ms = cs.graph_ms([call], 20, dev)
                row = dict(kernel=kernel, variant=name, case=case, ms=ms,
                           device_ms=dev_ms, max_abs_err=err,
                           ptxas=cs.ptxas_rows(ptxas), **extra)
                results.append(row)
                print(f"# {kernel} {name} {case}: {ms:.4f} ms (events), "
                      f"{dev_ms} ms (device), max |diff| {err}, "
                      f"{json.dumps(extra)}; ptxas " + cs.ptxas_text(ptxas),
                      flush=True)
                if err and not name.startswith("ablation"):
                    raise AssertionError(f"{kernel} {name} {case} differs "
                                         "from the committed kernel")
    card = cs.smi("name,power.limit")
    print(card)
    print(json.dumps({"card": card, "library_ms": library_ms,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
