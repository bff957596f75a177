"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

The main paths are the BLS12-381 G2 and G1 Pippenger MSMs of 2^20 points
(zikkurat_algebra_tpu_torch, `CurveKernels(...).msm(grp).msm_std`, c from
`window_size`, block 512), loading a compressed SRS (`decompress_g1`,
`decompress_g2`, `is_in_subgroup`, `Field.sqrt`), the BLS12-381 Fr
NTT, polynomial and group FFT path (`NTTDomain`, `PolyOps`, `GroupFFT`)
and the goldilocks NTT, the BLS12-381 pairing (`get_pairing`) and KZG
commit, open and verify (`protocols.kzg`), BigInt, the per-curve API
(`api.bls12_381`) and the sharded layer (`parallel/`).
The script

1. prints the card and its power limit, builds the five CUDA kernels from
   the sources in this checkout (one nvcc per source, in parallel) and
   prints the registers, spills and stack frames `-Xptxas -v` reports;
2. holds kernel K1 (Montgomery product) against its plain torch version
   on 2^20 random elements of BLS12-381 Fp, BLS12-381 Fr and BN128 Fp,
   and at the widths W = 1, 2, 3, 4, 8 of M31, goldilocks, 2^64 + 13,
   M127 and secp256k1's base field: exact limb equality; times both, the
   kernel by CUDA events and by device time (`graph_ms`: a CUDA graph
   of calls back to back, rotating over copies of the data larger in
   all than the L2; K2, K4 and K5 the same, K3 by the kernel durations
   of a torch.profiler trace, as its wrapper synchronises with the
   host; an event time above 1.5x the device time is marked
   host-bound);
3. G2 path, on the 1024 committed seeds of
   bench_data/seeds_BLS12_381_g2.npz (tiled) and random scalars:
   a. K3 (grouping sort) against its plain version on the path's own
      |digit| rows and on small edge cases (every key equal, sorted,
      reverse sorted, n = 1, n below one tile), exact; times the kernel,
      the plain version and torch.sort + gather; reads the pass kernel's
      resident CTAs per SM and its waves;
   b. K4 (Fp2 bucket accumulation) on the path's own inputs at block 512;
      its buckets and trailers are held against the plain version on two
      of the windows (the first and the carry window), at full n and
      full block, as points after `to_affine` (K4 sums sub-lanes with
      complete additions, like K2 below); times both; reads its resident
      CTAs per SM and its waves;
   c. the MSM: a 2^6-prefix check and a folded full-size check against
      the oracle, the launches of every kernel in that run (K1, K3 and K4
      must be > 0), then three timed runs with per-stage times and peak
      device memory;
4. G1 path, the same on bench_data/seeds_BLS12_381_g1.npz: K2 against its
   plain version on all windows, its buckets and trailers compared as
   points after `to_affine` (K2 sums sub-lanes with complete additions,
   so its projective coordinates differ from the plain version's), with
   its resident CTAs per SM and waves; then the MSM (K1, K2 and K3 must
   be launched);
5. SRS path (loading a compressed BLS12-381 SRS), every product on K1:
   a. the G1 seeds tiled to 2^20, compressed (`compress_g1`) and
      decompressed on the card (`decompress_g1`): equal to the seeds, a
      2^6 prefix equal to the oracle's decompression, four x with no
      point reported invalid; `g1.is_in_subgroup` (GLV) true on all
      2^20, `is_in_subgroup_slow` agreeing on 2^10, and both false on
      four oracle points outside the subgroup;
   b. the same for 2^12 G2 points (`decompress_g2` through `fp2_sqrt`,
      the subgroup test [r] P);
   c. `Field.sqrt` of 2^20 squares in BLS12-381 Fp (p = 3 mod 4) and Fr
      (Tonelli-Shanks, two-adicity 32): every root squared equals the
      square, a non-residue reports no root;
   each call's K1 launches (> 0) and host-clock ms of a second call;
6. NTT path, BLS12-381 Fr at 2^20:
   a. K5 (NTT stages in shared memory): one full radix-2 NTT of random
      inputs through the kernel and through `ntt_stages_plain`, pass by
      pass (`pass_plan`: 3 launches), equal limb for limb after each;
      then in turns one stage per launch, the passes, the passes, one
      stage per launch: the transform's K5 time by CUDA events and by
      device time, and by events with the bit-reversal gather; the bound
      of the whole transform;
   b. `NTTDomain.ntt`, `intt` and four-step `ntt`: table build timed
      apart, intt(ntt(x)) == x, four-step equal to radix-2, three outputs
      against sum_j x_j g^(j k) in Python ints, launches per transform
      (K1 and K5 must be > 0), three timed calls each;
   c. polynomials: `mul_ntt` of two 2^19-coefficient polynomials checked
      at a random point, `eval_at` and `quot_by_vanishing` (the KZG
      opening's steps) against Python Horner evaluations;
   d. group FFT over G1 at 2^14 (the seeds tiled): `fft` at two outputs
      against `msm_std` with scalars w^(j k), ifft(fft(P)) == P;
   e. K5 at W = 2: the same for a goldilocks NTT of 2^20 (2 passes),
      then `NTTDomain.ntt` equal to the kernel's passes,
      intt(ntt(x)) == x and three outputs against the sums;
7. pairing path, BLS12-381 (`PairingKernels`), on random points from a
   seeded torch.Generator: `pairing` on 1024 pairs (its first two values
   against the oracle), at batch 1, `miller_loop` and `final_exp` apart,
   bilinearity, pairing_product([P, -P], [Q, Q]) = 1 and the product of
   1024 pairs equal to the product of their pairings; the time and the
   launches of each call;
8. KZG path, BLS12-381 at n = 4096 (an EIP-4844 blob,
   protocols/kzg.py): `new_setup` by both Lagrange routes (equal), the
   first 8 tau_g1 and tau_g2 against the oracle, `commit_values` of a
   random blob equal to `commit_poly` of its intt, `opening_proof` with
   y0 equal to Horner, `verify_proof` true for it and false for y0 + 1
   and for another point's proof; the time and launches of each step;
9. BigInt (ops/bigint.py, plain torch ops, no kernel) at 256, 384 and
   768 bits on 2^20 random values: every operation, a 2^10 prefix
   against Python ints, host-clock ms of a second call, peak memory;
10. the per-curve API, `api.bls12_381("cuda")`: msm_g1.msm_mont of 2^20
   equal to msm_std, msm_g2.msm_mont of 2^16 equal to the oracle
   (folded), ntt_domain(20).ntt equal to NTTDomain, pairing of one pair
   equal to the oracle, K1-K5 each launched; then a torch.profiler trace
   of one G1 msm_mont of 2^16 (in a temporary directory): the ten
   kernels with the most device time and the device-busy share of the
   traced window and of the same call untraced;
11. the sharded layer (parallel/) in a world of 1 over NCCL:
   sharded_msm, ShardedNTT, ShardedPolyOps and sharded_sum / _dot at
   2^20 against their single-device functions and Horner, and
   ShardedGroupFFT at 2^10 against GroupFFT; K1, K2, K3 and K5 each
   launched.  One card shows that the path and the collectives run, not
   how they scale.

It imports torch, numpy and the port, never JAX.  It fails (nonzero exit,
no result line) without a CUDA card, outside a checkout, or when any
check fails.  The last two lines are the kernel table and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEEDS = {grp: os.path.join(ROOT, "bench_data", f"seeds_BLS12_381_{grp}.npz")
         for grp in ("g1", "g2")}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
IMAD_PER_CLOCK_PER_SM = 64         # compute capability 9.0, 32-bit multiply-add
COLD_BYTES = 1 << 28               # data `graph_ms` rotates over (L2 50 MB)
KERNELS = {                        # name -> (build source, TPU kernel replaced)
    "mont_mul": ("mont_mul", "zikkurat_algebra_tpu/ops/pallas_field.py:94"),
    "ntt_stage": ("ntt_stage",
                  "zikkurat_algebra_tpu/ops/pallas_field.py:125"),
    "bucket_scan": ("block_scan",
                    "zikkurat_algebra_tpu/ops/pallas_curve.py:241"),
    "bucket_scan2": ("block_scan2",
                     "zikkurat_algebra_tpu/ops/pallas_curve.py:328"),
    "sort_key_val": ("sort", "zikkurat_algebra_tpu/ops/pallas_sort.py:99"),
}


def log(msg: str):
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device):
    """(fn(), its wall time in ms, the device synchronised around it)."""
    sync(device)
    t = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t) * 1e3


def time_ms(fn, reps: int, device) -> float:
    """Mean time of fn() over reps runs after one warm-up: CUDA events on
    a card, the host clock on the CPU."""
    import torch

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def cold_copies(nbytes: int) -> int:
    """How many copies of a call's data (nbytes moved per call) `graph_ms`
    rotates over: at least COLD_BYTES in all, so that between two uses
    of a copy the other calls move more than the L2 holds."""
    return max(1, -(-COLD_BYTES // nbytes))


def graph_ms(fns, reps: int, device) -> float | None:
    """Device time of one call: a CUDA graph of at least reps calls back
    to back, call i running fns[i % len(fns)] (each on its own copy of the
    data, see `cold_copies`, so every call reads its inputs from device
    memory) and keeping what it returns (so every call writes to memory
    of its own), replayed three times and timed by CUDA events, over the
    calls.  A replay issues the kernels back to back, so no host time
    lies between them.  For calls that never synchronise with the host
    (every kernel but K3, see `profiler_ms`).  None on the CPU."""
    import torch

    if device.type != "cuda":
        return None
    for fn in fns:                           # builds, allocates, warms up
        fn()
    torch.cuda.synchronize()
    calls = len(fns) * -(-reps // len(fns))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        kept = [fns[i % len(fns)]() for i in range(calls)]
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del kept
    return start.elapsed_time(end) / (3 * calls)


def profiler_ms(fn, reps: int, device, names, per_call: int) -> float | None:
    """Device time of one fn() call for K3, whose wrapper reads the keys'
    range on the host and so cannot be captured in a CUDA graph: the
    durations of the CUDA kernels whose names contain one of `names`,
    summed over the last per_call * reps such kernels by start time in a
    torch.profiler trace of reps calls that follow reps // 2 more inside
    the same window, over reps.  The calls ahead of the measured ones are
    there because a window loses some of its first kernel records (11 to
    14 in a long process on the H100 host); a window that recorded fewer
    than per_call * reps is tried again, up to three times, then None.
    None on the CPU."""
    import torch
    from zikkurat_algebra_tpu_torch.utils import profiling

    if device.type != "cuda":
        return None
    need = per_call * reps
    for _ in range(3):
        with tempfile.TemporaryDirectory() as d:
            with profiling.trace(d):
                for _ in range(reps + reps // 2):
                    fn()
                torch.cuda.synchronize()
            ks = [(ts, dur) for name, ts, dur in kernel_events(os.path.join(
                d, profiling.TRACE_FILE)) if any(nm in name for nm in names)]
        if len(ks) >= need:
            return sum(dur for _, dur in sorted(ks)[-need:]) / reps / 1e3
        log(f"# profiler: {len(ks)} kernels named {names} in a window of "
            f"{reps + reps // 2} calls, want at least {need}; once more")
    log(f"# profiler: device time of {names} not measured")
    return None


def host_bound(ms: float, dev_ms: float | None) -> bool:
    """True where the event time exceeds the device time by more than
    1.5x: the events then timed the wrapper's host work, not the
    kernel."""
    return dev_ms is not None and ms > 1.5 * dev_ms


def host_note(ms: float, dev_ms: float | None) -> str:
    return ", host-bound in the events" if host_bound(ms, dev_ms) else ""


def rand_canonical(rng, p: int, W: int, n: int) -> np.ndarray:
    """n random values below p as (W, n) int32 limbs: random low limbs, a
    top limb below p's top limb."""
    limbs = rng.integers(0, 1 << 32, (W, n), dtype=np.uint64)
    limbs[-1] = rng.integers(0, p >> (32 * (W - 1)), n, dtype=np.uint64)
    return limbs.astype(np.uint32).view(np.int32)


def bound(nbytes: float, nops: float, int_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / int_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_limb_diff(got, want) -> int:
    """Largest |limb difference| between two nests of equal tensors."""
    import torch

    if isinstance(got, torch.Tensor):
        if got.shape != want.shape:
            raise AssertionError(f"shapes {tuple(got.shape)} and "
                                 f"{tuple(want.shape)} differ")
        return int((got.long() - want.long()).abs().max()) if got.numel() else 0
    return max(max_limb_diff(g, w) for g, w in zip(got, want))


def kernel_label(mangled: str) -> str:
    """`bucket_scan_kernel W=12` for a mangled entry name: the last
    component of its nested name, and the template's W."""
    name = mangled
    i = mangled.find("_ZN") + 3
    while i > 2 and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name = mangled[j:j + int(mangled[i:j])]
        i = j + int(mangled[i:j])
    w = re.search(r"ILi(\d+)E", mangled)
    return name + (f" W={w.group(1)}" if w else "")


def ptxas_report(text: str):
    """{entry label: (registers, spill store + load bytes, stack frame
    bytes)} from the -Xptxas -v log of one source."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = kernel_label(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            regs = out.get(cur, (None,))[0]
            out[cur] = (regs, int(m.group(2)) + int(m.group(3)),
                        int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)),) + out.get(cur, (None, 0, 0))[1:]
    return out


def ptxas_rows(rep) -> dict:
    return {k: {"registers": r, "spill_bytes": s, "stack_frame_bytes": f}
            for k, (r, s, f) in rep.items()}


def ptxas_text(rep) -> str:
    """A called function has no register count of its own."""
    return "; ".join(f"{k}: " + ("" if r is None else f"{r} registers, ")
                     + f"{s} B spilled, {f} B stack frame"
                     for k, (r, s, f) in rep.items())


def phase_build():
    from zikkurat_algebra_tpu_torch.utils import build

    t = time.perf_counter()
    secs = build.build(src for src, _ in KERNELS.values())
    log(f"# build: {time.perf_counter() - t:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    regs = {}
    for name, (src, _) in KERNELS.items():
        rep = ptxas_report(build.log_path(src).read_text())
        regs[name] = ptxas_rows(rep)
        log(f"# ptxas {src}: {ptxas_text(rep)}")
    return regs


def k1_fields():
    """The fields K1 is held at: BLS12-381 Fp and Fr and BN128 Fp of the
    MSM and NTT paths, then one prime per width the SRS path's fields do
    not reach (W = 1, 2, 3, 4) and a 256-bit curve field outside the
    three families (W = 8)."""
    from zikkurat_algebra_tpu_torch import params as P

    return (P.BLS12_381_FP, P.BLS12_381_FR, P.BN128_FP,
            P.TEST_PRIMES["M31"], P.TEST_PRIMES["goldilocks"],
            P.TEST_PRIMES["P64+"], P.TEST_PRIMES["M127"],
            P.curve_db_field("Secp256k1", "base"))


def phase_k1(device, n, int_rate, rng):
    """K1 against its plain version on n random elements of each of
    `k1_fields()`, exact limb equality; times both and the bound.  Returns
    BLS12-381 Fp's row with a `by_width` list of every field's numbers."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops import kernel_field
    from zikkurat_algebra_tpu_torch.ops.field import Field

    row, by_width = None, []
    for prm in k1_fields():
        f = Field(prm, device)
        a = torch.from_numpy(rand_canonical(rng, f.p, f.W, n)).to(device)
        b = torch.from_numpy(rand_canonical(rng, f.p, f.W, n)).to(device)
        got = kernel_field.mont_mul(a, b, f)
        want = kernel_field.mont_mul_plain(a, b, f)
        err = max_limb_diff(got, want)
        if err:
            raise AssertionError(f"K1 differs from its plain version on "
                                 f"{prm.name}: max |limb diff| {err}")
        ms = time_ms(lambda: kernel_field.mont_mul(a, b, f), 20, device)
        nbytes = 3 * 4 * f.W * n
        dev_ms = graph_ms([lambda a=a.clone(), b=b.clone():
                           kernel_field.mont_mul(a, b, f)
                           for _ in range(cold_copies(nbytes))], 20, device)
        plain_ms = time_ms(lambda: kernel_field.mont_mul_plain(a, b, f), 2,
                           device)
        nops = n * (4 * f.W * f.W + f.W)
        b_ms, b_by = bound(nbytes, nops, int_rate)
        hb = host_bound(ms, dev_ms)
        log(f"# K1 mont_mul {prm.name} W={f.W} n={n}: equal to plain; kernel "
            f"{ms:.4f} ms (events), {dev_ms} ms (device)"
            f"{host_note(ms, dev_ms)}; plain {plain_ms:.2f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {nops} IMAD)")
        by_width.append(dict(W=f.W, field=prm.name, n=n, ms=ms,
                             device_ms=dev_ms, event_host_bound=hb,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=err))
        if prm is P.BLS12_381_FP:
            row = dict(ms=ms, device_ms=dev_ms, event_host_bound=hb,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err, shape=f"({f.W}, {n}) {prm.name}")
    row["by_width"] = by_width
    return row


def occupancy_row(per_sm: int, ctas: int, sms: int) -> dict:
    """Resident CTAs per SM, CTAs launched, and waves: CTAs over the CTAs
    the card holds at once."""
    return dict(blocks_per_sm=per_sm, ctas=ctas,
                waves=ctas / (per_sm * sms) if per_sm else None)


def k3_edge_cases(device):
    """K3 against its plain version on small rows that stress the
    look-back and the ragged last tile; returns the largest difference."""
    import torch
    from zikkurat_algebra_tpu_torch.ops import kernel_sort

    rng = np.random.default_rng(7)     # apart from the paths' data
    bits, err = 15, 0
    keys = rng.integers(0, 1 << bits, (3, 20000))
    cases = {"every key equal": np.full_like(keys, 12345),
             "sorted": np.sort(keys, 1), "reverse": -np.sort(-keys, 1),
             "n = 1": keys[:, :1], "n below one tile": keys[:, :1000],
             "random, 3 payload rows": keys}
    for name, k in cases.items():
        kt = torch.from_numpy(np.ascontiguousarray(k, np.int32)).to(device)
        R = 3 if name.startswith("random") else 1
        pay = rng.integers(-(1 << 31), 1 << 31, (R,) + k.shape)
        pay = torch.from_numpy(pay.astype(np.int32)).to(device)
        e = max_limb_diff(kernel_sort.sort_key_val(kt, pay, bits),
                          kernel_sort.sort_key_val_plain(kt, pay))
        if e:
            raise AssertionError(f"K3 differs from its plain version on "
                                 f"{name}: max |diff| {e}")
        err = max(err, e)
    log(f"# K3 edge cases equal to plain: {', '.join(cases)}")
    return err


def phase_k3(msm, k_limbs, device, block, sms):
    """K3 on the path's own |digit| rows against its plain version, then
    on small edge cases."""
    import torch
    from zikkurat_algebra_tpu_torch.ops import kernel_sort
    from zikkurat_algebra_tpu_torch.ops.msm import window_size

    c = window_size(k_limbs.shape[-1])
    nbuckets = (1 << (c - 1)) + 1
    keys = msm.digits(k_limbs, c, block).abs()
    wc, n = keys.shape
    pos = torch.arange(n, dtype=torch.int32, device=device)
    pay = pos.expand(1, wc, n).contiguous()
    bits = nbuckets.bit_length()
    got = kernel_sort.sort_key_val(keys, pay, bits)
    want = kernel_sort.sort_key_val_plain(keys, pay)
    err = max_limb_diff(got, want)
    if err:
        raise AssertionError(f"K3 differs from its plain version: max |diff| "
                             f"{err}")
    err = max(err, k3_edge_cases(device))
    occ = (occupancy_row(*kernel_sort.occupancy(wc, n), sms)
           if device.type == "cuda" else {})
    ms = time_ms(lambda: kernel_sort.sort_key_val(keys, pay, bits), 10, device)
    # per call: the upsweep, the scan and one pass per 8 key bits
    dev_ms = profiler_ms(lambda: kernel_sort.sort_key_val(keys, pay, bits),
                         10, device, ("upsweep_kernel", "scan_kernel",
                                      "pass_kernel"), 2 + -(-bits // 8))
    plain_ms = time_ms(lambda: kernel_sort.sort_key_val_plain(keys, pay), 10,
                       device)

    def library():
        sk, order = torch.sort(keys, dim=1, stable=True)
        return sk, torch.gather(pay[0], 1, order)

    library_ms = time_ms(library, 10, device)
    # the function reads keys and payload once and writes both once
    nbytes = 2 * 4 * wc * n * (1 + pay.shape[0])
    b_ms, b_by = bound(nbytes, 0, 1.0)
    passes = -(-bits // 8)
    log(f"# K3 sort_key_val {wc} rows x {n}, key_bits={bits} ({passes} "
        f"passes): equal to plain; kernel {ms:.4f} ms (events), {dev_ms} ms "
        f"(device, profiler: upsweep, scan, passes){host_note(ms, dev_ms)}; "
        f"plain "
        f"{plain_ms:.4f} "
        f"ms, torch.sort + gather {library_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes} B); pass kernel {json.dumps(occ)}")
    return dict(ms=ms, device_ms=dev_ms,
                event_host_bound=host_bound(ms, dev_ms), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                max_abs_err=err,
                shape=f"{wc} rows x {n}, key_bits {bits}", **occ)


def scan_work(f, ncomp, pts, sd, idx, m, nbuckets):
    """Bytes (each input read once, each output written once) and the
    multiply-adds this run's data needs for the bucket scan: one madd of
    11 coordinate products (1 Montgomery product each over Fp, 3 over
    Fp2) at every position that neither restarts nor holds a point at
    infinity.  ncomp: 1 for Fp coordinates, 2 for Fp2."""
    import torch

    nwin, n = sd.shape
    a = sd.abs()
    restart = torch.ones_like(a, dtype=torch.bool)
    restart[:, 1:] = a[:, 1:] != a[:, :-1]
    restart[:, ::m] = True
    madds = int((~restart & ~pts[2][idx.long()]).sum())
    prods = 11 * (1 if ncomp == 1 else 3)
    nops = madds * prods * (4 * f.W * f.W + f.W)
    npts = pts[0].shape[-1]
    elem = 4 * f.W * ncomp
    nbytes = (2 * elem * npts + npts + 8 * nwin * n
              + 3 * elem * nwin * (nbuckets + 1 + n // m))
    return nbytes, nops, madds


def affine_diff(ops, got, want) -> int:
    """Largest |limb difference| between two projective batches after
    `to_affine`: the infinity flags, and x and y where finite.  The
    affine coordinates are canonical, so 0 means equal points mod p."""
    ga, wa = ops.to_affine(got), ops.to_affine(want)
    err = max_limb_diff(ga[2].int(), wa[2].int())
    live = ~wa[2]
    return max(err, max_limb_diff(tuple(t[..., live] for t in ga[:2]),
                                  tuple(t[..., live] for t in wa[:2])))


def phase_scan(ck, grp, k_limbs, pts, int_rate, device, m, sms,
               windows=None):
    """K2 (G1) or K4 (G2) on the path's own inputs against the plain
    version, on all windows or on the listed ones.  Both combine
    sub-lanes with complete additions, so their buckets and trailers are
    compared as points, after `to_affine`."""
    from zikkurat_algebra_tpu_torch.ops import kernel_curve

    ops = ck.g1 if grp == "g1" else ck.g2
    k = "K2" if grp == "g1" else "K4"
    c, nbuckets, gpts, sd, idx = ck.msm(grp).group(k_limbs, pts, None, m)
    args = (*gpts, sd, idx, m, nbuckets)
    got = kernel_curve.bucket_scan(ops, *args)
    nwin, n = sd.shape
    rows = list(range(nwin)) if windows is None else [w % nwin
                                                      for w in windows]
    want, plain_ms = timed(lambda: kernel_curve.bucket_scan_plain(
        ops.plain(), *gpts, sd[rows].contiguous(), idx[rows].contiguous(), m,
        nbuckets), device)
    got = tuple(tuple(c[..., rows, :] for c in p) for p in got)
    err = max(affine_diff(ops, g, w) for g, w in zip(got, want))
    how = "as points (after to_affine)"
    if err:
        raise AssertionError(f"{k} differs from its plain version {how}: max "
                             f"|limb diff| {err}")
    occ = {}
    if device.type == "cuda":
        query = (kernel_curve.bucket_scan_occupancy if grp == "g1"
                 else kernel_curve.bucket_scan2_occupancy)
        occ = occupancy_row(*query(ck.fp.W, nwin, n, m), sms)
    ms = time_ms(lambda: kernel_curve.bucket_scan(ops, *args), 3, device)
    # inputs of 300-450 MB: one copy already overflows the L2
    dev_ms = graph_ms([lambda: kernel_curve.bucket_scan(ops, *args)], 3,
                      device)
    ncomp = 1 if grp == "g1" else 2
    nbytes, nops, madds = scan_work(ck.fp, ncomp, gpts, sd, idx, m, nbuckets)
    b_ms, b_by = bound(nbytes, nops, int_rate)
    scope = ("all windows" if windows is None else
             f"windows {rows} of 0..{nwin - 1}")
    log(f"# {k} bucket_scan {grp} c={c} windows={nwin} n={n} block={m}: "
        f"buckets and trailers equal to plain {how} on {scope}; kernel "
        f"{ms:.3f} ms (all windows; events), {dev_ms} ms (device)"
        f"{host_note(ms, dev_ms)}, plain {plain_ms:.1f} ms ({scope}), "
        f"bound {b_ms:.3f} ms ({b_by}: {madds} madds, {nops} IMAD, {nbytes} "
        f"B); {json.dumps(occ)}")
    return dict(ms=ms, device_ms=dev_ms,
                event_host_bound=host_bound(ms, dev_ms), plain_ms=plain_ms,
                plain_scope=scope, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, max_abs_err=err,
                compared=how, shape=f"{nwin} windows x {n} points, block {m}",
                **occ)


def counters():
    from zikkurat_algebra_tpu_torch.ops import (kernel_curve, kernel_field,
                                                kernel_ntt, kernel_point,
                                                kernel_sort)

    return {"mont_mul": kernel_field.mont_mul,
            "ntt_stage": kernel_ntt.ntt_stages,
            "bucket_scan": kernel_curve.bucket_scan,
            "bucket_scan2": kernel_curve.bucket_scan2,
            "sort_key_val": kernel_sort.sort_key_val,
            "point_add": kernel_point.point_add,
            "point_dbl": kernel_point.point_dbl,
            "field_pow": kernel_field.field_pow}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts(device, path, need, per=None):
    """The launch counts since `reset_counts` or, given the per-call
    counts `per` of `counted_call`, their sum (so the single-device
    references a path is compared with are left out); each kernel in
    `need` must have been launched (on a card)."""
    launches = {name: fn.launches if per is None else
                sum(c.get(name, 0) for c in per.values())
                for name, fn in counters().items()}
    log(f"# launches on the {path} path: {json.dumps(launches)}")
    for name in need:
        if launches[name] == 0 and device.type == "cuda":
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path} path")
    return launches


def phase_msm(ck, grp, k_np, pts, seeds_aff, nseed, device, block, need):
    """The MSM of one group: the oracle checks, the launches of the folded
    run (each kernel in `need` must be > 0), three timed runs."""
    import torch
    from zikkurat_algebra_tpu_torch.ops.limbs import limbs_to_ints

    ops = ck.g1 if grp == "g1" else ck.g2
    og = ck.oracle_g1 if grp == "g1" else ck.oracle_g2
    decode = ck.decode_g1 if grp == "g1" else ck.decode_g2
    msm = ck.msm(grp)
    n = k_np.shape[1]
    k_limbs = torch.from_numpy(k_np).to(device)
    seeds = decode(seeds_aff)

    # (a) the bench.py check: scalars past a 2^6 prefix zeroed, full shape
    m = min(64, n)
    kpre = k_limbs.clone()
    kpre[:, m:] = 0
    got = decode(ops.to_affine(msm.msm_std(kpre, pts, None, block)))
    ks_pre = limbs_to_ints(k_np[:, :m])
    if got != og.msm(ks_pre, [seeds[i % nseed] for i in range(m)]):
        raise AssertionError(f"{grp} MSM prefix check vs the oracle FAILED")
    log(f"# {grp} MSM check (a): 2^6-prefix MSM at n={n} equals the oracle")

    # (b) every scalar live: fold the scalars onto the seeds
    folded = fold_scalars(k_np, nseed, og.r)
    reset_counts()
    t = time.perf_counter()
    res = msm.msm_std(k_limbs, pts, None, block)
    aff = ops.to_affine(res)
    sync(device)
    first_s = time.perf_counter() - t
    launches = read_counts(device, f"{grp} MSM + to_affine", need)
    t = time.perf_counter()
    want = og.msm(folded, seeds)
    oracle_s = time.perf_counter() - t
    if decode(aff) != want:
        raise AssertionError(f"{grp} MSM folded full-size check vs the oracle "
                             "FAILED")
    log(f"# {grp} MSM check (b): full 2^{n.bit_length() - 1} MSM equals the "
        f"oracle MSM of the {nseed} seeds with folded scalars "
        f"({first_s:.2f} s incl. to_affine; oracle {oracle_s:.1f} s)")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs = 3
    stages: dict = {}
    t = time.perf_counter()
    for i in range(runs):
        res = msm.msm_std(torch.roll(k_limbs, i + 1, 1), pts, None, block,
                          stage_seconds=stages)
    sync(device)
    per_run = (time.perf_counter() - t) / runs
    t = time.perf_counter()
    for _ in range(runs):
        aff = ops.to_affine(res)
    sync(device)
    stages["to_affine"] = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    log(f"# {grp} MSM n={n}: {per_run * 1e3:.1f} ms per msm_std, "
        f"{n / per_run:.1f} points/s over {runs} runs; peak device memory "
        f"{peak} B")
    log(f"# {grp} stage ms (mean of 3): " + ", ".join(
        f"{k} {v * 1e3 / runs:.2f}" for k, v in stages.items()))
    return launches


POINT_OP_PRODUCTS = {"add": 14, "dbl": 9}     # csrc/curve.cuh, b3 included


def phase_point_ops(device, int_rate, log_big=18, reps=200):
    """The point-op kernel (csrc/point_ops.cu) at W = 12 (BLS12-381) and 8
    (BN254): its ptxas report; at batch 2^log_big, addition and doubling
    against `plain()`'s torch law, limb for limb; each at batch 1 and
    2^log_big by device time (`graph_ms`), by events around the wrapper
    (host included), against its bound (products by `POINT_OP_PRODUCTS`,
    4 W^2 + W multiply-adds each; every coordinate read and written
    once).  Points: the committed seeds tiled, their coordinates scaled
    by random lambdas.  Returns the ptxas rows and the timings by
    `<op>_W<W>_n<batch>`."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
    from zikkurat_algebra_tpu_torch.utils import build
    from zikkurat_algebra_tpu_torch.utils.convert import load_jax_seed_points

    ptxas = {}
    if device.type == "cuda":
        build.build(["point_ops"])
        rep = ptxas_report(build.log_path("point_ops").read_text())
        ptxas = ptxas_rows(rep)
        log(f"# ptxas point_ops: {ptxas_text(rep)}")
    rows = {}
    for curve in (P.BLS12_381, P.BN128):
        ck = CurveKernels(curve, device)
        ops, f, fp = ck.g1, ck.fp, ck.fp.plain()
        seeds = f"seeds_{curve.name.replace('-', '_')}_g1.npz"
        x, y, _ = load_jax_seed_points(
            os.path.join(ROOT, "bench_data", seeds), f)
        g = torch.Generator().manual_seed(13)

        def points(n):
            i = torch.randint(0, x.shape[-1], (n,), generator=g).to(device)
            lam = fp.rnd(g, (n,))
            return tuple(fp.mul_list([(x[:, i], lam), (y[:, i], lam),
                                      (f.one((n,)), lam)]))

        big = 1 << log_big
        Pb, Qb = points(big), points(big)
        pl = ops.plain()
        for name, got, want in (("add", ops.add(Pb, Qb), pl.add(Pb, Qb)),
                                ("dbl", ops.dbl(Pb), pl.dbl(Pb))):
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"point_{name} W={f.W} differs from the "
                                     "torch law")
        for n in (1, big):
            # batch 1 is Horner's case: its point sits in the L2 anyway
            copies = (cold_copies(9 * 4 * f.W * n)
                      if n > 1 and device.type == "cuda" else 1)
            data = [(points(n), points(n)) for _ in range(copies)]
            for name in ("add", "dbl"):
                call = ((lambda a, b: ops.add(a, b)) if name == "add"
                        else (lambda a, b: ops.dbl(a)))
                nbytes = (9 if name == "add" else 6) * 4 * f.W * n
                nops = POINT_OP_PRODUCTS[name] * (4 * f.W * f.W + f.W) * n
                b_ms, b_by = bound(nbytes, nops, int_rate)
                ev_ms = time_ms(lambda: call(*data[0]), reps, device)
                dev_ms = graph_ms([lambda d=d: call(*d) for d in data], reps,
                                  device)
                key = f"{name}_W{f.W}_n{n}"
                rows[key] = dict(events_us=ev_ms * 1e3,
                                 device_us=None if dev_ms is None
                                 else dev_ms * 1e3,
                                 bound_us=b_ms * 1e3, bound_by=b_by)
                log(f"# point_{name} W={f.W} batch {n}: device "
                    f"{rows[key]['device_us']} us, events {ev_ms * 1e3:.2f} "
                    f"us (host included), bound {b_ms * 1e3:.3f} us ({b_by}: "
                    f"{nops} madds, {nbytes} B)"
                    + ("" if dev_ms is None or n == 1 else
                       f", {100 * b_ms / dev_ms:.1f}% of the bound"))
    return dict(ptxas=ptxas, timings=rows)


def phase_field_pow(device, int_rate, rng, log_big=20):
    """Kernel P2 (csrc/field_pow.cu): its ptxas report, and the powers the
    port takes by it on random elements at batch 1 and 2^log_big: the
    inverse a^(p-2) of BLS12-381 Fp (W = 12) and Fr (W = 8), Fp's square
    root a^((p+1)/4) and Fr's first Tonelli-Shanks power a^((q-1)/2).
    P2 must equal the plain version, `field_pow_plain` over
    `mont_mul_plain` (torch ops on the same tensors), limb for limb, and
    so must the K1 chain it replaces (the same loop over kernel K1).  P2
    and the K1 chain are timed by device time (`graph_ms`), by events
    around the call (host included) and against the bound (the chain's
    products at 4 W^2 + W multiply-adds each; the element read and
    written once); the plain loop by the host clock, once.  Returns the
    ptxas rows and the timings by `<path>_<power>_W<W>_n<batch>`."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops import kernel_field
    from zikkurat_algebra_tpu_torch.ops.field import Field
    from zikkurat_algebra_tpu_torch.utils import build

    ptxas = {}
    if device.type == "cuda":
        build.build(["field_pow"])
        rep = ptxas_report(build.log_path("field_pow").read_text())
        ptxas = ptxas_rows(rep)
        log(f"# ptxas field_pow: {ptxas_text(rep)}")
    rows = {}
    for prm in (P.BLS12_381_FP, P.BLS12_381_FR):
        f = Field(prm, device)
        q, _ = f._two_adic
        powers = {"inv": f.p - 2}
        if f.p % 4 == 3:
            powers["sqrt"] = (f.p + 1) // 4
        else:
            powers["ts_first"] = (q - 1) // 2
        for pname, e in powers.items():
            nprod = e.bit_length() - 2 + bin(e).count("1")
            paths = {"p2": lambda x, e=e: kernel_field.field_pow(x, e, f),
                     "k1_chain": lambda x, e=e: kernel_field.field_pow_plain(
                         x, e, f, kernel_field.mont_mul)}
            for n in (1, 1 << log_big):
                copies = (cold_copies(8 * f.W * n)
                          if n > 1 and device.type == "cuda" else 1)
                data = [torch.from_numpy(rand_canonical(rng, f.p, f.W, n)).to(
                    device) for _ in range(copies)]
                want, plain_ms = timed(
                    lambda: kernel_field.field_pow_plain(data[0], e, f),
                    device)
                for path, fn in paths.items():
                    if not torch.equal(fn(data[0]), want):
                        raise AssertionError(
                            f"field_pow {path} {pname} W={f.W} n={n} "
                            "differs from the plain version")
                reps = 20 if n == 1 else 3
                nbytes = 8 * f.W * n
                nops = nprod * (4 * f.W * f.W + f.W) * n
                b_ms, b_by = bound(nbytes, nops, int_rate)
                rows[f"plain_{pname}_W{f.W}_n{n}"] = dict(
                    host_ms=plain_ms, products=nprod)
                log(f"# field_pow plain {pname} W={f.W} batch {n}: "
                    f"{plain_ms:.1f} ms (host clock, device synchronised; "
                    f"{nprod} products); P2 and the K1 chain equal it")
                for path, fn in paths.items():
                    ev_ms = time_ms(lambda: fn(data[0]), reps, device)
                    dev_ms = graph_ms([lambda d=d: fn(d) for d in data], reps,
                                      device)
                    rows[f"{path}_{pname}_W{f.W}_n{n}"] = dict(
                        events_ms=ev_ms, device_ms=dev_ms, bound_ms=b_ms,
                        bound_by=b_by, products=nprod)
                    log(f"# field_pow {path} {pname} W={f.W} batch {n}: "
                        f"device {dev_ms} ms, events {ev_ms:.4f} ms (host "
                        f"included), bound {b_ms:.4f} ms ({b_by}: {nprod} "
                        "products)"
                        + ("" if dev_ms is None or n == 1 else
                           f", {100 * b_ms / dev_ms:.1f}% of the bound"))
    return dict(ptxas=ptxas, timings=rows)


def horner(coeffs, z: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % p
    return acc


def phase_k5(device, log_n, int_rate, rng, params=None):
    """K5 over one full radix-2 NTT of 2^log_n random elements of `params`
    (default BLS12-381 Fr): the passes of `pass_plan` through the kernel
    and through `ntt_stages_plain`, equal after every pass; then, in turns
    (one stage per launch, the passes, the passes, one stage per launch),
    the transform's K5 time by CUDA events around 20 calls and by
    `graph_ms` (device time), and by events with the bit-reversal gather
    before it; the gather's own device time.  Returns the row and
    the kernel's output."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops import kernel_ntt
    from zikkurat_algebra_tpu_torch.ops.field import Field
    from zikkurat_algebra_tpu_torch.ops.ntt import NTTDomain

    f = Field(params or P.BLS12_381_FR, device)
    n = 1 << log_n
    dom = NTTDomain(f, log_n)
    tables, perm = dom.tables(), dom.perm()
    plan = kernel_ntt.pass_plan(log_n, 0, kernel_ntt.tile_log(f.W))
    x = torch.from_numpy(rand_canonical(rng, f.p, f.W, n)).to(device)
    y0 = x.index_select(1, perm).reshape(f.W, 1, n, 1).contiguous()
    yk, yp = y0.clone(), y0.clone()
    err = 0
    for s0, k in plan:
        kernel_ntt.ntt_stages(yk, tables, s0, k, f)
        kernel_ntt.ntt_stages_plain(yp, tables, s0, k, f)
        err = max(err, max_limb_diff(yk, yp))
        if err:
            raise AssertionError(f"K5 differs from ntt_stages_plain after "
                                 f"stages {s0 + 1}..{s0 + k}: max |limb "
                                 f"diff| {err}")
    # the transform's K5 work: x read and written once, every stage table
    # read once; one Montgomery product (4 W^2 + W multiply-adds) per pair
    # per stage whose twiddle is not one (v * one = v; in this run's
    # tables entry 0 of every stage, so all of stage 1).  The gather reads
    # x and the int64 permutation, writes y.
    one = f.one_limbs.view(f.W, 1)
    prods = sum(int((t != one).any(0).sum()) * (n // (2 * t.shape[1]))
                for t in tables)
    tab_bytes = 4 * f.W * (n - 1)
    nbytes = 2 * 4 * f.W * n + tab_bytes
    gather_bytes = 2 * 4 * f.W * n + 8 * n
    nops = prods * (4 * f.W * f.W + f.W)
    b_ms, b_by = bound(nbytes, nops, int_rate)
    bg_ms, bg_by = bound(nbytes + gather_bytes, nops, int_rate)

    buf = y0.clone()
    bufs = [y0.clone() for _ in range(cold_copies(nbytes))]
    schedules = {"one stage per launch": [(s, 1) for s in range(log_n)],
                 "passes": plan}

    def run(sched, y, gather=False):
        def go():
            z = x.index_select(1, perm).view(f.W, 1, n, 1) if gather else y
            for s0, k in sched:
                kernel_ntt.ntt_stages(z, tables, s0, k, f)
        return go

    turns = []
    for name in ("one stage per launch", "passes", "passes",
                 "one stage per launch"):
        sched = schedules[name]
        turns.append(dict(
            schedule=name, launches=len(sched),
            ms=time_ms(run(sched, buf), 20, device),
            device_ms=graph_ms([run(sched, y) for y in bufs], 20, device),
            with_gather_ms=time_ms(run(sched, buf, True), 20, device)))
    gather_ms = graph_ms([lambda xc=x.clone(): xc.index_select(1, perm)
                          for _ in range(cold_copies(gather_bytes))], 20,
                         device)
    for t in turns:
        log(f"# K5 A/B {f.params.name} 2^{log_n} {t['schedule']} "
            f"({t['launches']} launches): {t['ms']:.4f} ms (events), "
            f"{t['device_ms']} ms (device); with the bit-reversal gather "
            f"{t['with_gather_ms']:.4f} ms (events)")
    log(f"# K5 bit-reversal gather (index_select) {f.params.name} 2^{log_n}: "
        f"{gather_ms} ms (device)")

    def plain_ntt():
        kernel_ntt.ntt_stages_plain(buf, tables, 0, log_n, f)

    plain_ms = time_ms(plain_ntt, 1, device)
    ours = [t for t in turns if t["schedule"] == "passes"]
    ms = min(t["ms"] for t in ours)
    dev = [t["device_ms"] for t in ours]
    dev_ms = None if None in dev else min(dev)
    occ = {}
    if device.type == "cuda":
        per_sm, smem = kernel_ntt.occupancy(f.W)
        occ = dict(blocks_per_sm=per_sm, smem_bytes_per_cta=smem)
    log(f"# K5 ntt_stages {f.params.name} n=2^{log_n}: passes {plan} equal "
        f"to ntt_stages_plain after each; {len(plan)} launches per NTT "
        f"(one per pass, {log_n} one stage per launch): {ms:.4f} ms per NTT "
        f"(events), {dev_ms} ms (device){host_note(ms, dev_ms)}; plain "
        f"{plain_ms:.3f} ms; bound {b_ms:.4f} ms per NTT ({b_by}: {nbytes} B, "
        f"{prods} products by a twiddle other than one, {nops} IMAD), with "
        f"the gather {bg_ms:.4f} ms ({bg_by}); "
        f"{json.dumps(occ)}")
    return dict(ms=ms, device_ms=dev_ms,
                event_host_bound=host_bound(ms, dev_ms), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                operations_ms=nops / int_rate * 1e3, products=prods,
                bound_with_gather_ms=bg_ms, gather_device_ms=gather_ms,
                library_ms=None, max_abs_err=err,
                passes=plan, launches_per_transform=len(plan), ab=turns,
                shape=f"({f.W}, 1, 2^{log_n}, 1) {f.params.name}, one "
                      "transform", **occ), (x, yk)


def phase_goldilocks(device, log_n, int_rate, rng):
    """K5 at W = 2: one full NTT of 2^log_n goldilocks elements through
    the kernel and its plain version, pass by pass (`phase_k5`), then
    `NTTDomain.ntt` / `intt` on the card: ntt equal to the kernel's
    pass-by-pass result, intt(ntt(x)) == x, three outputs equal to
    sum_j x_j g^(j k)."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops.field import Field
    from zikkurat_algebra_tpu_torch.ops.ntt import NTTDomain

    prm = P.TEST_PRIMES["goldilocks"]
    row, (x, yk) = phase_k5(device, log_n, int_rate, rng, prm)
    f = Field(prm, device)
    dom = NTTDomain(f, log_n).prepare()
    reset_counts()
    y, ntt_ms = timed(lambda: dom.ntt(x), device)
    back, intt_ms = timed(lambda: dom.intt(y), device)
    launches = read_counts(device, "goldilocks NTT", ("ntt_stage",
                                                     "mont_mul"))
    if not torch.equal(y, yk.reshape(y.shape)):
        raise AssertionError("goldilocks ntt differs from the kernel's "
                             "pass-by-pass NTT")
    if not torch.equal(back, x):
        raise AssertionError("goldilocks intt(ntt(x)) != x")
    n = 1 << log_n
    xs = f.decode(x)
    k3 = int(rng.integers(2, n))
    for k, g in zip((0, 1, k3), f.decode(y[:, [0, 1, k3]])):
        w, acc, tot = pow(dom.gen, k, f.p), 1, 0
        for v in xs:
            tot += v * acc
            acc = acc * w % f.p
        if tot % f.p != g:
            raise AssertionError(f"goldilocks NTT output {k} differs from "
                                 "the sum")
    log(f"# goldilocks NTT 2^{log_n}: ntt equals the pass-by-pass K5 "
        f"NTT, intt(ntt(x)) == x, outputs 0, 1, {k3} equal the sums; ntt "
        f"{ntt_ms:.3f} ms, intt {intt_ms:.3f} ms (first calls, host clock)")
    row.update(ntt_ms=ntt_ms, intt_ms=intt_ms)
    return launches, row


def phase_ntt(device, log_n, rng):
    """NTTDomain at 2^log_n: tables, checks, launches, timings."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops.field import Field
    from zikkurat_algebra_tpu_torch.ops.ntt import NTTDomain

    f = Field(P.BLS12_381_FR, device)
    n = 1 << log_n
    dom, four = NTTDomain(f, log_n), NTTDomain(f, log_n, four_step=True)
    _, tab_ms = timed(dom.prepare, device)
    _, tab4_ms = timed(four.prepare, device)
    log(f"# NTT 2^{log_n} tables: radix-2 {tab_ms:.1f} ms, four-step "
        f"{tab4_ms:.1f} ms (both directions)")
    x = torch.from_numpy(rand_canonical(rng, f.p, f.W, n)).to(device)
    per = {}

    def counted(name, fn, arg):
        before = {k: c.launches for k, c in counters().items()}
        out = fn(arg)
        sync(device)
        per[name] = {k: c.launches - before[k] for k, c in counters().items()
                     if c.launches != before[k]}
        return out

    reset_counts()
    y = counted("ntt", dom.ntt, x)
    back = counted("intt", dom.intt, y)
    y4 = counted("four-step ntt", four.ntt, x)
    launches = read_counts(device, "NTT", ("mont_mul", "ntt_stage"))
    log(f"# NTT launches per transform: {json.dumps(per)}")
    if not torch.equal(back, x):
        raise AssertionError("intt(ntt(x)) != x")
    if not torch.equal(y4, y):
        raise AssertionError("four-step NTT differs from radix-2")
    k3 = int(rng.integers(2, n))
    xs = f.decode(x)
    got = f.decode(y[:, [0, 1, k3]])
    for k, g in zip((0, 1, k3), got):
        w, acc, tot = pow(dom.gen, k, f.p), 1, 0
        for v in xs:
            tot += v * acc
            acc = acc * w % f.p
        if tot % f.p != g:
            raise AssertionError(f"NTT output {k} differs from the sum")
    log(f"# NTT checks: intt(ntt(x)) == x, four-step == radix-2 limb for "
        f"limb, outputs 0, 1, {k3} equal sum_j x_j g^(j k)")
    times = {name: time_ms(fn, 3, device) for name, fn in (
        ("ntt", lambda: dom.ntt(x)), ("intt", lambda: dom.intt(x)),
        ("four-step ntt", lambda: four.ntt(x)))}
    log(f"# NTT 2^{log_n} ms (mean of 3): " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()))
    return launches, dict(tables_ms=tab_ms, four_tables_ms=tab4_ms,
                          per_transform=per, ms=times)


def phase_poly(device, log_n, rng):
    """mul_ntt of two 2^(log_n - 1)-coefficient polynomials, eval_at and
    quot_by_vanishing on 2^log_n coefficients, against Python ints."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops.field import Field
    from zikkurat_algebra_tpu_torch.ops.poly import get_poly_ops

    f = Field(P.BLS12_381_FR, device)
    po = get_poly_ops(f)
    n = 1 << log_n
    a, b, pp = (torch.from_numpy(rand_canonical(rng, f.p, f.W, k)).to(device)
                for k in (n // 2, n // 2, n))
    z, x0 = (int.from_bytes(rng.bytes(40), "little") % f.p for _ in range(2))
    po.mul_ntt(a, b)                            # builds the 2^log_n tables
    reset_counts()
    c, mul_ms = timed(lambda: po.mul_ntt(a, b), device)
    y0, eval_ms = timed(lambda: po.eval_at(f.encode(x0), pp), device)
    (q, ok), quot_ms = timed(lambda: po.quot_by_vanishing(
        po.sub(pp, y0.view(f.W, 1)), 1, f.encode(x0)), device)
    launches = read_counts(device, "polynomial", ("mont_mul", "ntt_stage"))
    av, bv, cv, pv, qv = (f.decode(t) for t in (a, b, c, pp, q))
    if len(cv) != n - 1 or horner(cv, z, f.p) != horner(av, z, f.p) * \
            horner(bv, z, f.p) % f.p:
        raise AssertionError("mul_ntt: A(z) B(z) != C(z)")
    p_x0 = horner(pv, x0, f.p)
    if f.decode(y0) != p_x0:
        raise AssertionError("eval_at differs from Horner")
    if not bool(ok) or (horner(qv, z, f.p) * (z - x0) + p_x0) % f.p != \
            horner(pv, z, f.p):
        raise AssertionError("quot_by_vanishing: q(z)(z - x0) + y0 != P(z)")
    times = {"mul_ntt": mul_ms, "eval_at": eval_ms,
             "quot_by_vanishing": quot_ms}
    log(f"# poly checks at 2^{log_n}: mul_ntt at a random point, eval_at, "
        f"quot_by_vanishing exact and q(z)(z - x0) + y0 = P(z); ms: "
        + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))
    return launches, times


def phase_gfft(ck, device, log_n, block, rng):
    """GroupFFT over G1 at 2^log_n on the tiled seeds: two outputs of
    fft against msm_std with scalars w^(j k); ifft(fft(P)) == P."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops.gfft import get_group_fft

    ops = ck.g1
    n = 1 << log_n
    _, _, aff = tiled_seeds(ck, "g1", n, device)
    g = get_group_fft(ops, P.BLS12_381_FR, log_n)
    reset_counts()
    F, fft_ms = timed(lambda: g.fft(ops.from_affine(aff)), device)
    B, ifft_ms = timed(lambda: g.ifft(F), device)
    launches = read_counts(device, "group FFT", ("point_add", "point_dbl"))
    back = ops.to_affine(B)
    if not (torch.equal(back[2], aff[2]) and all(
            torch.equal(u[:, ~aff[2]], v[:, ~aff[2]])
            for u, v in zip(back[:2], aff[:2]))):
        raise AssertionError("ifft(fft(P)) != P")
    Fa = ops.to_affine(F)
    k2 = int(rng.integers(2, n))
    for k in (1, k2):
        w, acc, ks = pow(g.gen, k, g.r), 1, []
        for _ in range(n):
            ks.append(acc)
            acc = acc * w % g.r
        want = ck.msm("g1").msm_std(ck.fr.encode(ks, mont=False), aff, None,
                                    block)
        if ck.decode_g1(ops.to_affine(want)) != ck.decode_g1(
                tuple(t[..., k] for t in Fa)):
            raise AssertionError(f"group FFT output {k} differs from the "
                                 "MSM")
    log(f"# group FFT G1 2^{log_n}: outputs 1 and {k2} equal msm_std with "
        f"scalars w^(j k); ifft(fft(P)) == P; fft {fft_ms:.0f} ms, ifft "
        f"{ifft_ms:.0f} ms")
    return launches, {"fft": fft_ms, "ifft": ifft_ms}


def counted_call(per, times, device, name, fn):
    """fn() once, its launches per kernel in per[name] and its host-clock
    ms (device synchronised around it) in times[name]."""
    before = {k: c.launches for k, c in counters().items()}
    out, times[name] = timed(fn, device)
    per[name] = {k: c.launches - before[k] for k, c in counters().items()
                 if c.launches != before[k]}
    return out


def phase_pairing(device, batch, rng):
    """The BLS12-381 pairing on random points ([k] G for k from a seeded
    torch.Generator): `pairing` on `batch` pairs (the main-path run, its
    launches counted), its first two values against the oracle, the
    bilinearity e([a]P, Q) = e(P, [a]Q) = e(P, Q)^a,
    pairing_product([P, -P], [Q, Q]) = 1, pairing_product of the batch
    equal to the product of its pairings; times `pairing` at 1 and
    `batch` pairs, `pairing_product` at 2 and `batch`, and `miller_loop`
    and `final_exp` apart, with the launches of each call."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops.pairing import get_pairing

    pk = get_pairing(P.BLS12_381, device)
    ck, tw = pk.ck, pk.tower
    f12, o12 = tw.fp12, pk.oracle.f12
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 62)))
    Pa = ck.g1.to_affine(ck.rnd_point(gen, (batch,), "g1"))
    Qa = ck.g2.to_affine(ck.rnd_point(gen, (batch,), "g2"))
    sync(device)
    per, times = {}, {}
    call = lambda name, fn: counted_call(per, times, device, name, fn)

    reset_counts()
    e = call(f"pairing x{batch}", lambda: pk.pairing(Pa, Qa))
    launches = read_counts(device, "pairing", ("mont_mul", "field_pow"))
    two = lambda A: tuple(t[..., :2] for t in A)
    ps, qs = ck.decode_g1(two(Pa)), ck.decode_g2(two(Qa))
    want = [pk.oracle.pairing(p, q) for p, q in zip(ps, qs)]
    if tw.decode_fp12(e[..., :2]) != want:
        raise AssertionError("pairing differs from the oracle on the 2-pair "
                             "prefix")
    one = lambda A: tuple(t[..., :1] for t in A)
    e1 = call("pairing x1", lambda: pk.pairing(one(Pa), one(Qa)))
    f1 = call("miller_loop x1", lambda: pk.miller_loop(one(Pa), one(Qa)))
    g1 = call("final_exp x1", lambda: pk.final_exp(f1))
    fb = call(f"miller_loop x{batch}", lambda: pk.miller_loop(Pa, Qa))
    gb = call(f"final_exp x{batch}", lambda: pk.final_exp(fb))
    if not (torch.equal(e1, e[..., :1]) and torch.equal(g1, e1)
            and torch.equal(gb, e)):
        raise AssertionError("pairing at batch 1, or final_exp(miller_loop), "
                             "differs from the batch's pairing")

    a = int(rng.integers(2, 1 << 62))
    P0 = ck.g1.from_affine(one(Pa))
    Q0 = ck.g2.from_affine(one(Qa))
    aP = ck.g1.to_affine(ck.g1.scalar_mul_static(a, P0))
    aQ = ck.g2.to_affine(ck.g2.scalar_mul_static(a, Q0))
    cat = lambda *As: tuple(torch.cat(ts, -1) for ts in zip(*As))
    bil = tw.decode_fp12(call("pairing x3 (bilinearity)", lambda: pk.pairing(
        cat(aP, one(Pa), one(Pa)), cat(one(Qa), aQ, one(Qa)))))
    if not (bil[0] == bil[1] == o12.pow(bil[2], a) and bil[2] != o12.one):
        raise AssertionError("bilinearity e([a]P, Q) = e(P, [a]Q) = "
                             "e(P, Q)^a fails")
    negP = ck.g1.to_affine(ck.g1.neg(P0))
    prod2 = call("pairing_product x2", lambda: pk.pairing_product(
        cat(one(Pa), negP), cat(one(Qa), one(Qa))))
    if tw.decode_fp12(prod2) != o12.one:
        raise AssertionError("pairing_product([P, -P], [Q, Q]) != 1")
    prodb = call(f"pairing_product x{batch}",
                 lambda: pk.pairing_product(Pa, Qa))
    acc = e
    while acc.shape[-1] > 1:
        k = acc.shape[-1]
        if k % 2:
            acc = torch.cat([acc, f12.one((1,))], -1)
            k += 1
        acc = f12.mul(acc[..., :k // 2], acc[..., k // 2:])
    if not torch.equal(prodb, acc[..., 0]):
        raise AssertionError("pairing_product differs from the product of "
                             "the pairings")
    log(f"# pairing BLS12-381: the 2-pair prefix of pairing x{batch} equals "
        f"the oracle; batch 1 and final_exp(miller_loop) equal it; "
        f"e([a]P, Q) = e(P, [a]Q) = e(P, Q)^a; e(P, Q) e(-P, Q) = 1; "
        f"pairing_product x{batch} = the product of the pairings")
    for name, ms in times.items():
        n = int(name.split(" x")[1].split()[0])
        rate = (f", {n / ms * 1e3:.1f} pairs/s" if name.startswith("pairing")
                else "")
        log(f"# pairing {name}: {ms:.1f} ms{rate}; launches "
            f"{json.dumps(per[name])}")
    return launches, dict(ms=times, launches_per_call=per)


def phase_kzg(ck, device, log_n, rng):
    """KZG on BLS12-381 at n = 2^log_n (an EIP-4844 blob at 12): new_setup
    by both Lagrange routes (equal), the first 8 tau_g1 and tau_g2 against
    the oracle; commit_values of a random blob equal to commit_poly of its
    intt; opening_proof at a random x0 with y0 equal to Horner;
    verify_proof true for it, false for y0 + 1 and for the proof of
    another point.  Times and launches of each step."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops.ntt import get_domain
    from zikkurat_algebra_tpu_torch.protocols import kzg

    fr, og1, og2 = ck.fr, ck.oracle_g1, ck.oracle_g2
    n = 1 << log_n
    tau = int.from_bytes(rng.bytes(40), "little") % fr.p
    per, times = {}, {}
    call = lambda name, fn: counted_call(per, times, device, name, fn)
    reset_counts()
    setup = call("new_setup", lambda: kzg.new_setup(P.BLS12_381, log_n, tau,
                                                     device=device))
    gsetup = call("new_setup (group iFFT)", lambda: kzg.new_setup(
        P.BLS12_381, log_n, tau, use_group_fft=True, device=device))
    same = all(torch.equal(u, v) for u, v in zip(setup.lagrange_tau_g1,
                                                 gsetup.lagrange_tau_g1))
    if not same or any(not torch.equal(u, v) for u, v in zip(
            setup.tau_g1, gsetup.tau_g1)):
        raise AssertionError("new_setup: the scalar and group-iFFT routes "
                             "differ")
    first = ck.decode_g1(tuple(t[..., :8] for t in setup.tau_g1))
    if first != [og1.scalar_mul(pow(tau, i, fr.p), og1.gen)
                 for i in range(8)] or ck.decode_g2(setup.tau_g2) != [
                     og2.scalar_mul(tau, og2.gen)]:
        raise AssertionError("new_setup: tau_g1[:8] or tau_g2 differs from "
                             "the oracle")
    values = torch.from_numpy(rand_canonical(rng, fr.p, fr.W, n)).to(device)
    com_v = call("commit_values", lambda: kzg.commit_values(setup, values))
    coeffs = call("intt", lambda: get_domain(fr, log_n).intt(values))
    com_p = call("commit_poly", lambda: kzg.commit_poly(setup, coeffs))
    if not bool(ck.g1.eq(com_v, com_p)):
        raise AssertionError("commit_values(v) != commit_poly(intt(v))")
    x0, x1 = (fr.encode(int.from_bytes(rng.bytes(40), "little") % fr.p)
              for _ in range(2))
    y0, proof = call("opening_proof", lambda: kzg.opening_proof(
        setup, coeffs, x0))
    if fr.decode(y0) != horner(fr.decode(coeffs), fr.decode(x0), fr.p):
        raise AssertionError("opening_proof: y0 differs from Horner")
    ok = call("verify_proof", lambda: kzg.verify_proof(setup, com_p, proof,
                                                       x0, y0))
    launches = read_counts(device, "KZG", ("mont_mul", "bucket_scan",
                                           "sort_key_val", "ntt_stage",
                                           "point_add", "point_dbl",
                                           "field_pow"))
    bad_y = kzg.verify_proof(setup, com_p, proof, x0,
                             fr.add(y0, fr.one(())))
    _, proof1 = kzg.opening_proof(setup, coeffs, x1)
    bad_x = kzg.verify_proof(setup, com_p, proof1, x0, y0)
    if not bool(ok) or bool(bad_y) or bool(bad_x):
        raise AssertionError(f"verify_proof: honest {bool(ok)}, y0 + 1 "
                             f"{bool(bad_y)}, another x0's proof "
                             f"{bool(bad_x)}")
    log(f"# KZG BLS12-381 n=2^{log_n}: both Lagrange routes equal, tau_g1[:8] "
        f"and tau_g2 equal the oracle, commit_values(v) = "
        f"commit_poly(intt(v)), y0 = Horner, verify true for the honest "
        f"proof, false for y0 + 1 and for another x0's proof")
    for name, ms in times.items():
        log(f"# KZG {name}: {ms:.1f} ms; launches {json.dumps(per[name])}")
    return launches, dict(ms=times, launches_per_call=per)


def oracle_decompress(og, sqrt, x, par):
    """The oracle's point with x and y's parity bit `par` (y of c0, or of
    c1 where c0 = 0, over Fp2), or None where x^3 + b is no square."""
    f = og.f
    y = sqrt(f.add(f.mul(f.mul(x, x), x), og.b))
    if y is None:
        return None
    sign = y if isinstance(y, int) else (y[0] if y[0] else y[1])
    return (x, y if sign % 2 == par else f.neg(y))


def outside_points(og, sqrt, rnd, k):
    """k points on the curve outside the r-subgroup, from the oracle."""
    f, out = og.f, []
    while len(out) < k:
        x = rnd()
        y = sqrt(f.add(f.mul(f.mul(x, x), x), og.b))
        if y is not None and og.scalar_mul_unreduced(og.r, (x, y)) is not None:
            out.append((x, y))
    return out


def phase_srs(ck, device, log_g1, log_g2, log_sqrt, rng):
    """Loading a compressed SRS: the tiled G1 and G2 seeds compressed,
    decompressed on the card (equal to the seeds; a prefix against the
    oracle; x with no point reports invalid), the subgroup tests (GLV for
    G1, [r] P for G2; held against the slow test on a prefix and on
    points outside the subgroup), then Field.sqrt on squares of BLS12-381
    Fp and Fr.  Each path call runs once counted and checked, then once
    timed on the host clock."""
    import random

    import torch

    og1, og2 = ck.oracle_g1, ck.oracle_g2
    fo, f2o = og1.f, og2.f
    r = random.Random(int(rng.integers(1 << 62)))
    per, times = {}, {}
    total = {}

    def call(name, fn, need=("mont_mul",)):
        before = {k: c.launches for k, c in counters().items()}
        out = fn()
        sync(device)
        per[name] = {k: c.launches - before[k] for k, c in counters().items()
                     if c.launches != before[k]}
        for k in need:
            if device.type == "cuda" and not per[name].get(k):
                raise AssertionError(f"{name}: {k} was not launched")
        for k, v in per[name].items():
            total[k] = total.get(k, 0) + v
        _, times[name] = timed(fn, device)
        return out

    def check_group(grp, n, enc, dec_x, comp, decomp, ops, og, osqrt, ornd):
        _, _, pts = tiled_seeds(ck, grp, n, device)
        x, flags = comp(pts)
        (xd, yd, infd), valid = call(f"decompress_{grp}",
                                     lambda: decomp(x, flags),
                                     ("mont_mul", "field_pow"))
        live = ~pts[2]
        if not (bool(valid.all()) and torch.equal(infd, pts[2])
                and all(torch.equal(u[..., live], v[..., live])
                        for u, v in zip((xd, yd), pts[:2]))):
            raise AssertionError(f"decompress_{grp} differs from the seeds")
        decode = ck.decode_g1 if grp == "g1" else ck.decode_g2
        want = [None if fl & 2 else oracle_decompress(og, osqrt, xi, fl & 1)
                for xi, fl in zip(dec_x(x[..., :64]), flags[:64].tolist())]
        if decode(tuple(t[..., :64] for t in (xd, yd, infd))) != want:
            raise AssertionError(f"decompress_{grp} prefix differs from the "
                                 "oracle")
        bad = []
        while len(bad) < 4:
            xb = ornd()
            if osqrt(og.f.add(og.f.mul(og.f.mul(xb, xb), xb), og.b)) is None:
                bad.append((xb, xb))
        xb, _, _ = enc(bad)
        _, vb = decomp(xb, torch.zeros(4, dtype=torch.int32, device=device))
        if bool(vb.any()):
            raise AssertionError(f"decompress_{grp}: an x with no point "
                                 "reported valid")
        P = ops.from_affine((xd, yd, infd))
        name = f"is_in_subgroup_{grp}"
        inside = call(name, lambda: ops.is_in_subgroup(P))
        m = min(n, 1 << 10)
        slow = ops.is_in_subgroup_slow(tuple(c[..., :m] for c in P))
        outs = ops.from_affine(enc(outside_points(og, osqrt, ornd, 4)))
        if not (bool(inside.all()) and bool(slow.all())
                and not bool(ops.is_in_subgroup(outs).any())
                and not bool(ops.is_in_subgroup_slow(outs).any())):
            raise AssertionError(f"{name} wrong: seeds in {bool(inside.all())}"
                                 f", slow on 2^{m.bit_length() - 1} "
                                 f"{bool(slow.all())}, outside points out")
        log(f"# SRS {grp} 2^{n.bit_length() - 1}: decompress equals the seeds "
            f"(2^6 prefix equals the oracle, 4 x with no point invalid); "
            f"{name} true on all, the slow test agrees on 2^"
            f"{m.bit_length() - 1}, 4 points outside the subgroup rejected "
            f"by both; launches {json.dumps(per[f'decompress_{grp}'])}, "
            f"{json.dumps(per[name])}")

    reset_counts()
    check_group("g1", 1 << log_g1, ck.encode_g1, ck.fp.decode,
                ck.compress_g1, ck.decompress_g1, ck.g1, og1, fo.sqrt,
                lambda: r.randrange(fo.p))
    check_group("g2", 1 << log_g2, ck.encode_g2, ck.tower.decode_fp2,
                ck.compress_g2, ck.decompress_g2, ck.g2, og2, f2o.sqrt,
                lambda: (r.randrange(fo.p), r.randrange(fo.p)))
    n = 1 << log_sqrt
    for f in (ck.fp, ck.fr):
        a = torch.from_numpy(rand_canonical(rng, f.p, f.W, n)).to(device)
        sq = f.sqr(a)
        root, ok = call(f"sqrt {f.params.name}", lambda: f.sqrt(sq),
                        ("mont_mul", "field_pow"))
        if not (bool(ok.all()) and torch.equal(f.sqr(root), sq)):
            raise AssertionError(f"sqrt {f.params.name}: a root squared is "
                                 "not the square")
        if bool(f.sqrt(f.encode([f.params.multiplicative_gen]))[1].any()):
            raise AssertionError(f"sqrt {f.params.name}: a non-residue "
                                 "reported square")
        got, av = f.decode(root[:, :64]), f.decode(a[:, :64])
        if any(g not in (v, (f.p - v) % f.p) for g, v in zip(got, av)):
            raise AssertionError(f"sqrt {f.params.name}: a root is not +-a")
        log(f"# SRS sqrt {f.params.name} 2^{log_sqrt}: every root squared is "
            f"the square, a non-residue reports no root, 2^6 roots are +-a; "
            f"launches {json.dumps(per[f'sqrt {f.params.name}'])}")
    launches = read_counts(device, "SRS", ())
    log("# SRS ms per call (host clock, second call, device synchronised): "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    counts = {k: total.get(k, 0) for k in launches}
    return counts, dict(ms=times, launches_per_call=per)


BIGINT_OPS = ("add", "sub", "neg", "mul", "mul_ext", "sqr_ext", "scale_ext",
              "inc", "dec", "shift_left", "shift_right")


def phase_bigint(device, log_n, rng, widths=(256, 384, 768), shift=77):
    """BigInt (ops/bigint.py, plain torch ops, no kernel) on 2^log_n
    random values of each width: every operation once, a 2^10 prefix of
    each result held against Python ints exactly, then the host-clock ms
    of a second call (device synchronised) and the peak device memory of
    the width's calls above what the process held before them."""
    import torch
    from zikkurat_algebra_tpu_torch.ops.bigint import bigint

    n = 1 << log_n
    m = min(n, 1 << 10)
    out = {}
    for bits in widths:
        B = bigint(bits, device)
        top = 1 << bits
        a, b = (torch.from_numpy(rng.integers(0, 1 << 32, (B.W, n),
                                              dtype=np.uint64)
                                 .astype(np.uint32).view(np.int32)).to(device)
                for _ in range(2))
        w = torch.from_numpy(rng.integers(0, 1 << 32, n)).to(device)
        calls = {"add": lambda: B.add(a, b), "sub": lambda: B.sub(a, b),
                 "neg": lambda: B.neg(a), "mul": lambda: B.mul(a, b),
                 "mul_ext": lambda: B.mul_ext(a, b),
                 "sqr_ext": lambda: B.sqr_ext(a),
                 "scale_ext": lambda: B.scale_ext(w, a),
                 "inc": lambda: B.inc(a), "dec": lambda: B.dec(a),
                 "shift_left": lambda: B.shift_left(a, shift),
                 "shift_right": lambda: B.shift_right(a, shift)}
        av, bv = B.decode(a[:, :m]), B.decode(b[:, :m])
        wv = w[:m].tolist()
        want = {
            "add": ([(x + y) % top for x, y in zip(av, bv)],
                    [(x + y) // top for x, y in zip(av, bv)]),
            "sub": ([(x - y) % top for x, y in zip(av, bv)],
                    [int(x < y) for x, y in zip(av, bv)]),
            "neg": [(-x) % top for x in av],
            "mul": [x * y % top for x, y in zip(av, bv)],
            "mul_ext": [x * y for x, y in zip(av, bv)],
            "sqr_ext": [x * x for x in av],
            "scale_ext": [v * x for v, x in zip(wv, av)],
            "inc": ([(x + 1) % top for x in av], [(x + 1) // top for x in av]),
            "dec": ([(x - 1) % top for x in av], [int(x == 0) for x in av]),
            "shift_left": [(x << shift) % top for x in av],
            "shift_right": [x >> shift for x in av]}
        base = 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        times = {}
        for name in BIGINT_OPS:
            got = calls[name]()
            if isinstance(got, tuple):
                ok = (B.decode(got[0][:, :m]), got[1][:m].tolist()) \
                    == want[name]
            else:
                ok = B.decode(got[:, :m]) == want[name]
            if not ok:
                raise AssertionError(f"BigInt {bits} {name} differs from "
                                     "Python ints on the 2^10 prefix")
            _, times[name] = timed(calls[name], device)
        peak = (torch.cuda.max_memory_allocated() - base
                if device.type == "cuda" else 0)
        log(f"# BigInt {bits} n=2^{log_n}: every operation equals Python "
            f"ints on a 2^10 prefix; peak device memory {peak} B above what "
            "was allocated before its calls (its inputs among that); ms "
            "(host clock, second call): " + ", ".join(
                f"{k} {v:.3f}" for k, v in times.items()))
        out[bits] = dict(ms=times, peak_bytes=peak)
    return out


def kernel_name(name: str) -> str:
    """A kernel's demangled name without its return type, argument list
    and namespaces, cut to 100 characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i][:100]
    return name[:100]


def kernel_events(trace_file):
    """The device kernels of a Chrome trace as (name, start us, us)."""
    with open(trace_file) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") == "kernel" and "dur" in e]


def trace_kernels(trace_file):
    """From a Chrome trace: the device kernels by summed time, as (name,
    us, count), most first, and the microseconds in which at least one
    kernel ran."""
    ks = kernel_events(trace_file)
    by = {}
    for name, _, dur in ks:
        t, c = by.get(name, (0.0, 0))
        by[name] = (t + dur, c + 1)
    busy, end = 0.0, None
    for s, d in sorted((ts, dur) for _, ts, dur in ks):
        if end is None or s > end:
            busy += d
            end = s + d
        elif s + d > end:
            busy += s + d - end
            end = s + d
    top = sorted(by.items(), key=lambda kv: -kv[1][0])
    return [(k, t, c) for k, (t, c) in top], busy


def phase_api(device, log_n, g2_log_n, ntt_log_n, trace_log_n, block, rng,
              trace_dir):
    """The per-curve API, `bls12_381(device)`: msm_g1.msm_mont of 2^log_n
    equal to `CurveKernels(...).msm("g1").msm_std` on the same points and
    scalars (after to_affine); msm_g2.msm_mont of 2^g2_log_n (the first
    64 G2 seeds tiled) equal to the oracle on the folded scalars;
    ntt_domain(ntt_log_n).ntt equal to a fresh NTTDomain; pairing of one
    pair equal to the oracle.  K1-K5 must each be launched.  Then a
    torch.profiler trace of one G1 msm_mont of 2^trace_log_n: the ten
    device kernels with the most summed time, and the traced window's
    device-busy share; K2's and K3's kernels must be in it."""
    import torch
    from zikkurat_algebra_tpu_torch import api, params as P
    from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
    from zikkurat_algebra_tpu_torch.ops.ntt import NTTDomain
    from zikkurat_algebra_tpu_torch.utils import profiling

    a = api.bls12_381(device)
    fr = a.fr
    per, times = {}, {}
    call = lambda name, fn: counted_call(per, times, device, name, fn)
    n = 1 << log_n
    _, _, pts = tiled_seeds(a.curves, "g1", n, device)
    k_mont = torch.from_numpy(rand_canonical(rng, fr.p, fr.W, n)).to(device)
    other = CurveKernels(P.BLS12_381, device).msm("g1")
    want = other.msm_std(fr.from_mont(k_mont), pts, None, block)
    reset_counts()
    got = call(f"msm_g1.msm_mont 2^{log_n}",
               lambda: a.msm_g1.msm_mont(k_mont, pts, None, block))
    err = affine_diff(a.g1, tuple(t.unsqueeze(-1) for t in got),
                      tuple(t.unsqueeze(-1) for t in want))
    if err:
        raise AssertionError("api msm_g1.msm_mont differs from msm_std")

    seeds2 = tuple(t[..., :64] for t in tiled_seeds(a.curves, "g2", 64,
                                                    device)[0])
    n2 = 1 << g2_log_n
    pts2 = tuple(t.repeat(*([1] * (t.ndim - 1)), n2 // 64).contiguous()
                 for t in seeds2)
    k2 = rand_canonical(rng, fr.p, fr.W, n2)
    k2_mont = fr.to_mont(torch.from_numpy(k2).to(device))
    r2 = call(f"msm_g2.msm_mont 2^{g2_log_n}",
              lambda: a.msm_g2.msm_mont(k2_mont, pts2, None, block))
    if a.decode_g2(a.g2.to_affine(tuple(t.unsqueeze(-1) for t in r2))) != [
            a.curves.oracle_g2.msm(fold_scalars(k2, 64, fr.p),
                                   a.decode_g2(seeds2))]:
        raise AssertionError("api msm_g2.msm_mont differs from the oracle")

    x = torch.from_numpy(rand_canonical(rng, fr.p, fr.W, 1 << ntt_log_n)).to(
        device)
    dom = a.ntt_domain(ntt_log_n).prepare()
    y = call(f"ntt_domain({ntt_log_n}).ntt", lambda: dom.ntt(x))
    if not torch.equal(y, NTTDomain(fr, ntt_log_n).ntt(x)):
        raise AssertionError("api ntt_domain.ntt differs from NTTDomain")

    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 62)))
    Pa = a.g1.to_affine(a.curves.rnd_point(gen, (1,), "g1"))
    Qa = a.g2.to_affine(a.curves.rnd_point(gen, (1,), "g2"))
    e = call("pairing.pairing x1", lambda: a.pairing.pairing(Pa, Qa))
    if a.tower.decode_fp12(e[..., :1]) != [a.pairing.oracle.pairing(
            a.decode_g1(Pa)[0], a.decode_g2(Qa)[0])]:
        raise AssertionError("api pairing differs from the oracle")
    launches = read_counts(device, "API", tuple(counters()), per)
    log(f"# API bls12_381: msm_g1.msm_mont 2^{log_n} equals msm_std, "
        f"msm_g2.msm_mont 2^{g2_log_n} equals the oracle (folded onto 64 "
        f"seeds), ntt_domain({ntt_log_n}).ntt equals NTTDomain, pairing x1 "
        "equals the oracle")
    for name, ms in times.items():
        log(f"# API {name}: {ms:.1f} ms (host clock, first call); launches "
            f"{json.dumps(per[name])}")

    # one traced G1 MSM: recording every host op slows the host several
    # times, not the kernels, so the kernels' busy time is also set
    # against the wall time of the same call untraced
    nt = 1 << trace_log_n
    kt, pt = k_mont[:, :nt].contiguous(), tuple(t[..., :nt].contiguous()
                                                for t in pts)
    msm_t = lambda: a.msm_g1.msm_mont(kt, pt, None, block)
    msm_t()                                             # warm
    _, plain_wall = timed(msm_t, device)
    t0 = time.perf_counter()
    with profiling.trace(trace_dir):
        msm_t()
        sync(device)
    wall = (time.perf_counter() - t0) * 1e3
    top, busy = trace_kernels(os.path.join(trace_dir, profiling.TRACE_FILE))
    busy /= 1e3
    names = " ".join(k for k, _, _ in top)
    if device.type == "cuda" and not all(
            k in names for k in ("bucket_scan_kernel", "pass_kernel")):
        raise AssertionError(f"the traced G1 MSM shows no K2 or K3 kernel: "
                             f"{names[:300]}")
    log(f"# API trace: G1 msm_mont 2^{trace_log_n}: {wall:.1f} ms wall "
        f"traced, {plain_wall:.1f} ms untraced; kernels ran {busy:.3f} ms: "
        f"device busy {100 * busy / wall:.2f}% of the traced window, "
        f"{100 * busy / plain_wall:.2f}% of the untraced call; "
        f"{sum(c for _, _, c in top)} kernels of {len(top)} kinds; top 10 "
        "by device time: " + "; ".join(
            f"{kernel_name(k)} {t / 1e3:.3f} ms x{c}"
            for k, t, c in top[:10]))
    return launches, dict(ms=times, launches_per_call=per, trace=dict(
        wall_ms=wall, untraced_ms=plain_wall, kernel_busy_ms=busy,
        busy_share_traced=busy / wall, busy_share_untraced=busy / plain_wall,
        top=[dict(name=kernel_name(k), ms=t / 1e3, count=c)
             for k, t, c in top[:10]]))


def phase_parallel(device, log_n, gfft_log_n, block, rng):
    """The sharded layer (parallel/) in a world of 1 over NCCL (gloo on
    the CPU), a file store in a temporary directory, destroyed at the end:
    sharded_msm G1 at 2^log_n equal to msm_std; ShardedNTT at 2^log_n
    equal to NTTDomain.ntt, its intt inverting it; ShardedPolyOps.mul of
    two 2^(log_n - 1)-coefficient polynomials at a point, eval_at and
    div_by_vanishing(n_van=16) against Horner; sharded_sum and
    sharded_dot against sum_mod and dot_prod; ShardedGroupFFT G1 at
    2^gfft_log_n equal to GroupFFT.  One card shows only that the code
    path and the collectives run, not how they scale."""
    import torch
    import torch.distributed as dist
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops import vector as V
    from zikkurat_algebra_tpu_torch.ops.curve import get_curves
    from zikkurat_algebra_tpu_torch.ops.gfft import get_group_fft
    from zikkurat_algebra_tpu_torch.ops.ntt import get_domain
    from zikkurat_algebra_tpu_torch.parallel import mesh as M
    from zikkurat_algebra_tpu_torch.parallel.gfft import ShardedGroupFFT
    from zikkurat_algebra_tpu_torch.parallel.msm import sharded_msm
    from zikkurat_algebra_tpu_torch.parallel.ntt import ShardedNTT
    from zikkurat_algebra_tpu_torch.parallel.poly import ShardedPolyOps
    from zikkurat_algebra_tpu_torch.parallel.vector import (sharded_dot,
                                                            sharded_sum)

    ck = get_curves(P.BLS12_381, device)
    fr = ck.fr
    n = 1 << log_n
    with tempfile.TemporaryDirectory() as tmp:
        M.init_multihost(f"file://{tmp}/store", 1, 0, device=device.type)
        try:
            mesh = M.make_mesh()
            backend = dist.get_backend()
            per, times = {}, {}
            call = lambda name, fn: counted_call(per, times, device, name, fn)
            _, _, pts = tiled_seeds(ck, "g1", n, device)
            k = torch.from_numpy(rand_canonical(rng, fr.p, fr.W, n)).to(device)
            sh = lambda t: M.shard_batch(mesh, t)
            reset_counts()
            got = call(f"sharded_msm 2^{log_n}", lambda: sharded_msm(
                ck.msm("g1"), mesh, sh(k), tuple(sh(t) for t in pts), None,
                block))
            want = ck.msm("g1").msm_std(k, pts, None, block)
            if affine_diff(ck.g1, tuple(t.unsqueeze(-1) for t in got),
                           tuple(t.unsqueeze(-1) for t in want)):
                raise AssertionError("sharded_msm differs from msm_std")

            x = torch.from_numpy(rand_canonical(rng, fr.p, fr.W, n)).to(device)
            sntt = ShardedNTT(fr, log_n, mesh)
            for inverse in (False, True):             # built before timing
                sntt.twiddles(inverse)
            y = call(f"ShardedNTT.ntt 2^{log_n}", lambda: sntt.ntt(sh(x)))
            back = call(f"ShardedNTT.intt 2^{log_n}", lambda: sntt.intt(y))
            if not torch.equal(M.gather_batch(mesh, y),
                               get_domain(fr, log_n).ntt(x)):
                raise AssertionError("ShardedNTT.ntt differs from NTTDomain")
            if not torch.equal(M.gather_batch(mesh, back), x):
                raise AssertionError("ShardedNTT.intt(ntt(x)) != x")

            po = ShardedPolyOps(fr, log_n, mesh)
            half = torch.from_numpy(rand_canonical(rng, fr.p, fr.W, n)).to(
                device)
            half[:, n // 2:] = 0
            hb = torch.roll(half, 1, 1)
            hb[:, n // 2:] = 0
            c = call(f"ShardedPolyOps.mul 2^{log_n - 1} x 2^{log_n - 1}",
                     lambda: po.mul(sh(half), sh(hb)))
            z, x0, eta = (int.from_bytes(rng.bytes(40), "little") % fr.p
                          for _ in range(3))
            y0 = call(f"ShardedPolyOps.eval_at 2^{log_n}",
                      lambda: po.eval_at(fr.encode(x0), sh(x)))
            (q, rem) = call(f"ShardedPolyOps.div_by_vanishing 2^{log_n}, "
                            "n_van=16", lambda: po.div_by_vanishing(
                                sh(x), 16, fr.encode(eta)))
            s = call(f"sharded_sum 2^{log_n}", lambda: sharded_sum(
                fr, mesh, sh(x)))
            d = call(f"sharded_dot 2^{log_n}", lambda: sharded_dot(
                fr, mesh, sh(x), sh(half)))
            av, bv, cv, xv, qv = (fr.decode(M.gather_batch(mesh, t)) for t in
                                  (sh(half), sh(hb), c, sh(x), q))
            p = fr.p
            if horner(cv, z, p) != horner(av, z, p) * horner(bv, z, p) % p:
                raise AssertionError("ShardedPolyOps.mul: A(z) B(z) != C(z)")
            if fr.decode(y0) != horner(xv, x0, p):
                raise AssertionError("ShardedPolyOps.eval_at differs from "
                                     "Horner")
            if any(qv[-16:]) or (horner(qv, z, p) * (pow(z, 16, p) - eta)
                                 + horner(fr.decode(rem), z, p)) % p != \
                    horner(xv, z, p):
                raise AssertionError("ShardedPolyOps.div_by_vanishing: "
                                     "q(z)(z^16 - eta) + r(z) != P(z)")
            if not (torch.equal(s, V.sum_mod(fr, x))
                    and torch.equal(d, V.dot_prod(fr, x, half))):
                raise AssertionError("sharded_sum or sharded_dot differs "
                                     "from sum_mod or dot_prod")

            ng = 1 << gfft_log_n
            Pg = ck.g1.from_affine(tuple(t[..., :ng] for t in pts))
            sg = ShardedGroupFFT(ck.g1, P.BLS12_381_FR, gfft_log_n, mesh)
            F = call(f"ShardedGroupFFT.fft 2^{gfft_log_n}", lambda: sg.fft(
                tuple(sh(t) for t in Pg)))
            G = get_group_fft(ck.g1, P.BLS12_381_FR, gfft_log_n).fft(Pg)
            if affine_diff(ck.g1, tuple(M.gather_batch(mesh, t) for t in F),
                           G):
                raise AssertionError("ShardedGroupFFT differs from GroupFFT")
            launches = read_counts(device, "sharded", (
                "mont_mul", "bucket_scan", "sort_key_val", "ntt_stage",
                "field_pow"), per)
        finally:
            dist.destroy_process_group()
    log(f"# sharded ({backend}, a world of 1 on one card: the code path and "
        "the collectives run; no scaling is shown): sharded_msm equals "
        "msm_std, ShardedNTT equals NTTDomain and intt inverts it, "
        "ShardedPolyOps mul / eval_at / div_by_vanishing agree with Horner, "
        "sharded_sum / sharded_dot equal sum_mod / dot_prod, "
        "ShardedGroupFFT equals GroupFFT")
    for name, ms in times.items():
        log(f"# sharded {name}: {ms:.1f} ms (host clock, first call); "
            f"launches {json.dumps(per[name])}")
    return launches, dict(ms=times, launches_per_call=per, backend=backend)



def fold_scalars(k_np: np.ndarray, nseed: int, r: int):
    """Scalars (Wr, n) of n points that tile `nseed` seeds -> the nseed
    sums of the scalars on each seed, mod r: the MSM of the tiled points
    equals the MSM of the seeds with these."""
    from zikkurat_algebra_tpu_torch.ops.limbs import limbs_to_ints

    cols = k_np.view(np.uint32).astype(np.uint64).reshape(
        k_np.shape[0], k_np.shape[1] // nseed, nseed).sum(1)
    return [v % r for v in limbs_to_ints(cols_to_limbs(cols))]


def cols_to_limbs(cols: np.ndarray) -> np.ndarray:
    """(W, N) uint64 column sums -> (W + 2, N) int32 limbs of the values."""
    W, N = cols.shape
    out = np.zeros((W + 2, N), np.uint64)
    carry = np.zeros(N, np.uint64)
    for i in range(W + 2):
        t = (cols[i] if i < W else 0) + carry
        out[i] = t & 0xFFFFFFFF
        carry = t >> np.uint64(32)
    return out.astype(np.uint32).view(np.int32)


def tiled_seeds(ck, grp, n, device):
    """The committed seeds of `grp` and their tiling to n points."""
    from zikkurat_algebra_tpu_torch.utils.convert import load_jax_seed_points

    seeds = load_jax_seed_points(SEEDS[grp], ck.fp)
    nseed = seeds[0].shape[-1]
    reps = -(-n // nseed)
    pts = tuple(s.repeat(*([1] * (s.ndim - 1)), reps)[..., :n].contiguous()
                for s in seeds)
    return seeds, nseed, pts


def run(device_name: str = "cuda", log_n: int = 20, k1_log_n: int = 20,
        block: int = 512, ntt_log_n: int = 20, gfft_log_n: int = 14,
        srs_log_n: int = 20, srs_g2_log_n: int = 12, gold_log_n: int = 20,
        pairing_batch: int = 1024, kzg_log_n: int = 12,
        bigint_log_n: int = 20, api_g2_log_n: int = 16,
        trace_log_n: int = 16, sharded_gfft_log_n: int = 10,
        point_log_n: int = 18, pow_log_n: int = 20):
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels

    device = torch.device(device_name)
    card = smi("name,power.limit") if device.type == "cuda" else "cpu"
    log(card)
    regs = {}
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(0)
        clock_mhz = float(smi("clocks.max.sm").split()[0])
        int_rate = IMAD_PER_CLOCK_PER_SM * props.multi_processor_count \
            * clock_mhz * 1e6
        log(f"# {props.multi_processor_count} SMs, max SM clock {clock_mhz} "
            f"MHz: int32 multiply-add peak {int_rate:.4g}/s")
        regs = phase_build()
    else:
        int_rate = IMAD_PER_CLOCK_PER_SM * 132 * 1980e6
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if device.type == "cuda" else 132)
    rng = np.random.default_rng(20)
    meas = {"mont_mul": phase_k1(device, 1 << k1_log_n, int_rate, rng)}
    ck = CurveKernels(P.BLS12_381, device)

    # the G2 path
    n = 1 << log_n
    seeds, nseed, pts = tiled_seeds(ck, "g2", n, device)
    k_np = rand_canonical(rng, ck.fr.p, ck.fr.W, n)
    k_limbs = torch.from_numpy(k_np).to(device)
    meas["sort_key_val"] = phase_k3(ck.msm("g2"), k_limbs, device, block,
                                    sms)
    meas["bucket_scan2"] = phase_scan(ck, "g2", k_limbs, pts, int_rate,
                                      device, block, sms, windows=(0, -1))
    launches = {"g2": phase_msm(ck, "g2", k_np, pts, seeds, nseed, device,
                                block, ("mont_mul", "sort_key_val",
                                        "bucket_scan2", "field_pow"))}

    # the G1 path
    seeds, nseed, pts = tiled_seeds(ck, "g1", n, device)
    k_np = rand_canonical(rng, ck.fr.p, ck.fr.W, n)
    meas["bucket_scan"] = phase_scan(ck, "g1", torch.from_numpy(k_np).to(
        device), pts, int_rate, device, block, sms)
    launches["g1"] = phase_msm(ck, "g1", k_np, pts, seeds, nseed, device,
                               block, ("mont_mul", "sort_key_val",
                                       "bucket_scan", "point_add",
                                       "point_dbl", "field_pow"))
    point_ops = phase_point_ops(device, int_rate, point_log_n)
    field_pow = phase_field_pow(device, int_rate, rng, pow_log_n)

    # the SRS path: decompression, subgroup checks, square roots
    launches["srs"], meas["mont_mul"]["srs_path"] = phase_srs(
        ck, device, srs_log_n, srs_g2_log_n, srs_log_n, rng)

    # the NTT, polynomial and group-FFT path
    meas["ntt_stage"], _ = phase_k5(device, ntt_log_n, int_rate, rng)
    launches["ntt"], meas["ntt_stage"]["ntt_path"] = phase_ntt(
        device, ntt_log_n, rng)
    launches["poly"], meas["ntt_stage"]["poly_ms"] = phase_poly(
        device, ntt_log_n, rng)
    launches["gfft"], meas["ntt_stage"]["gfft_ms"] = phase_gfft(
        ck, device, gfft_log_n, block, rng)
    launches["ntt_goldilocks"], meas["ntt_stage"]["goldilocks"] = \
        phase_goldilocks(device, gold_log_n, int_rate, rng)

    # the pairing, and KZG commit / open / verify
    launches["pairing"], meas["mont_mul"]["pairing_path"] = phase_pairing(
        device, pairing_batch, rng)
    launches["kzg"], meas["mont_mul"]["kzg_path"] = phase_kzg(
        ck, device, kzg_log_n, rng)

    # BigInt (no kernel), the per-curve API and the sharded layer
    phase_bigint(device, bigint_log_n, rng)
    with tempfile.TemporaryDirectory() as trace_dir:
        launches["api"], meas["mont_mul"]["api_path"] = phase_api(
            device, log_n, api_g2_log_n, ntt_log_n, trace_log_n, block, rng,
            trace_dir)
    launches["sharded"], meas["mont_mul"]["sharded_path"] = phase_parallel(
        device, log_n, sharded_gfft_log_n, block, rng)

    rows = []
    for name, (src, rep) in KERNELS.items():
        row = dict(name=name, route="cuda",
                   source=f"zikkurat_algebra_tpu_torch/csrc/{src}.cu",
                   replaces=rep,
                   launches=sum(v[name] for v in launches.values()),
                   launches_by_path={k: v[name] for k, v in launches.items()},
                   library_ms=None, ptxas=regs.get(name, {}))
        row.update(meas[name])
        rows.append(row)
    log(card)
    print(json.dumps({"kernels": rows}))
    point = ("point_add", "point_dbl")
    print(json.dumps({"point_ops": dict(
        source="zikkurat_algebra_tpu_torch/csrc/point_ops.cu",
        replaces="the Field chains of ProjCurveOps.add / .dbl "
                 "(zikkurat_algebra_tpu_torch/ops/curve.py)",
        launches={k: sum(v[k] for v in launches.values()) for k in point},
        launches_by_path={p: {k: v[k] for k in point}
                          for p, v in launches.items()},
        **point_ops)}))
    print(json.dumps({"field_pow": dict(
        source="zikkurat_algebra_tpu_torch/csrc/field_pow.cu",
        replaces="the K1 chain of Field.pow_bits "
                 "(zikkurat_algebra_tpu_torch/ops/field.py)",
        launches=sum(v["field_pow"] for v in launches.values()),
        launches_by_path={p: v["field_pow"] for p, v in launches.items()},
        **field_pow)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(0) if device.type == "cuda"
                 else "cpu"),
        "count": torch.cuda.device_count(),
    }}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    run("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
