"""Time variants of kernels K2 (G1 bucket scan) and K3 (grouping sort) on
one NVIDIA card.

    python3 scripts/kernel_variants.py

A variant is the kernel's source in this checkout with a few text edits: a
register cap, the number of sub-lanes, a Montgomery product written with
PTX carry chains, the keys per thread.  The script builds every variant
with the flags of zikkurat_algebra_tpu_torch/utils/build.py (one nvcc per
variant, all started together) into build/variants/, prints the registers
and spills ptxas reports, and runs each on the BLS12-381 G1 path's inputs
at 2^20 (the committed seeds tiled, random scalars, block 512), as
chip_smoke.py gives them to K2 and K3.  Each variant is checked against
the committed kernel (K2's buckets and trailers as points after
`to_affine`, K3 exactly) and timed with CUDA events; the committed kernel
runs first and last.  The last line is a JSON object with every number,
the line before it the card's name and power limit.  It needs a CUDA
card and nvcc.
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
K3_PASS = "__launch_bounds__(kThreads, 4)\npass_kernel("
K3_VARIANTS = {
    "no register cap": [(K3_PASS, "__launch_bounds__(kThreads)\npass_kernel(")],
    "11 keys per thread": [("constexpr int kPerThread = 15;",
                            "constexpr int kPerThread = 11;")],
    "19 keys per thread": [("constexpr int kPerThread = 15;",
                            "constexpr int kPerThread = 19;")],
}


def build_all(build):
    """Write and compile every variant; {(kernel, name): (library, ptxas
    report)} for those that built."""
    import chip_smoke as cs

    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mont_cc.cuh").write_text(MONT_MUL_CC)
    jobs = {}
    for kernel, src, variants in (("K2", "block_scan", K2_VARIANTS),
                                  ("K3", "sort", K3_VARIANTS)):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops import kernel_curve, kernel_sort
    from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
    from zikkurat_algebra_tpu_torch.utils import build

    t = time.perf_counter()
    built = build_all(build)
    print(f"# {len(built)} variants built in {time.perf_counter() - t:.1f} s")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ck = CurveKernels(P.BLS12_381, dev)
    f, ops, n, m = ck.fp, ck.g1, 1 << 20, 512
    _, _, pts = cs.tiled_seeds(ck, "g1", n, dev)
    rng = np.random.default_rng(20)
    k_limbs = torch.from_numpy(cs.rand_canonical(rng, ck.fr.p, ck.fr.W,
                                                 n)).to(dev)
    c, nbuckets, gpts, sd, idx = ck.msm("g1").group(k_limbs, pts, None, m)
    nwin = sd.shape[0]
    ref = kernel_curve.bucket_scan(ops, *gpts, sd, idx, m, nbuckets)
    results = []

    def k2_call(lib):
        fn = lib.zk_bucket_scan
        fn.argtypes, fn.restype = kernel_curve._ARGTYPES, ctypes.c_int

        def call():
            b, S = kernel_curve._outputs(ops, sd, m, nbuckets)
            rc = fn(*(t.data_ptr() for t in (*gpts, sd, idx) + b + S),
                    kernel_curve._host_words(f.p, f.W), f.n0,
                    kernel_curve._host_words(f.R % f.p, f.W), ops.b3, f.W,
                    nwin, n, gpts[0].shape[1], m, nbuckets + 1,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
            return b, S
        return call

    def k2_occupancy(lib):
        per, ctas = ctypes.c_int(), ctypes.c_longlong()
        fn = lib.zk_bucket_scan_occupancy
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn(f.W, nwin, n, m, ctypes.addressof(per), ctypes.addressof(ctas))
        return per.value, ctas.value

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
        size.argtypes, size.restype = [ctypes.c_int] * 3, ctypes.c_longlong
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

    def k3_occupancy(lib):
        per, ctas = ctypes.c_int(), ctypes.c_longlong()
        fn = lib.zk_sort_occupancy
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        fn(wc, nk, ctypes.addressof(per), ctypes.addressof(ctas))
        return per.value, ctas.value

    for kernel, variants, make, occupancy, reps in (
            ("K2", K2_VARIANTS, k2_call, k2_occupancy, 3),
            ("K3", K3_VARIANTS, k3_call, k3_occupancy, 20)):
        names = ["committed", *variants, "committed"]
        for name in names:
            if (kernel, name) not in built:
                continue
            lib, ptxas = built[(kernel, name)]
            call = make(lib)
            got = call()
            torch.cuda.synchronize()
            if kernel == "K2":
                err = max(cs.affine_diff(ops, g, w) for g, w in zip(got, ref))
            else:
                err = cs.max_limb_diff(got, want)
            ms = cs.time_ms(call, reps, dev)
            per_sm, ctas = occupancy(lib)
            row = dict(kernel=kernel, variant=name, ms=ms, max_abs_err=err,
                       blocks_per_sm=per_sm, ctas=ctas,
                       waves=ctas / (per_sm * sms) if per_sm else None,
                       ptxas={k: {"registers": r, "spill_bytes": s}
                              for k, (r, s) in ptxas.items()})
            results.append(row)
            print(f"# {kernel} {name}: {ms:.4f} ms, max |diff| {err}, "
                  f"{per_sm} CTAs per SM, {row['waves']} waves; ptxas "
                  + "; ".join(f"{k}: {r} registers, {s} B spilled"
                              for k, (r, s) in ptxas.items()), flush=True)
            if err:
                raise AssertionError(f"{kernel} {name} differs from the "
                                     "committed kernel")
    library_ms = cs.time_ms(lambda: kernel_sort.sort_key_val_plain(keys, pay),
                            20, dev)
    print(f"# torch.sort(stable=True) + gather: {library_ms:.4f} ms")
    card = cs.smi("name,power.limit")
    print(card)
    print(json.dumps({"card": card, "library_ms": library_ms,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
