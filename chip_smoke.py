"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

The main paths are the BLS12-381 G2 and G1 Pippenger MSMs of 2^20 points
(zikkurat_algebra_tpu_torch, `CurveKernels(...).msm(grp).msm_std`, c from
`window_size`, block 512), loading a compressed SRS (`decompress_g1`,
`decompress_g2`, `is_in_subgroup`, `Field.sqrt`), and the BLS12-381 Fr
NTT, polynomial and group FFT path (`NTTDomain`, `PolyOps`, `GroupFFT`).
The script

1. prints the card and its power limit, builds the five CUDA kernels from
   the sources in this checkout (one nvcc per source, in parallel) and
   prints the registers, spills and stack frames `-Xptxas -v` reports;
2. holds kernel K1 (Montgomery product) against its plain torch version
   on 2^20 random elements of BLS12-381 Fp, BLS12-381 Fr and BN128 Fp,
   and at the widths W = 1, 2, 3, 4, 8 of M31, goldilocks, 2^64 + 13,
   M127 and secp256k1's base field: exact limb equality; times both;
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
   a. K5 (NTT butterfly stage): one full radix-2 NTT of random inputs
      through the kernel and through its plain version, every stage
      equal limb for limb; times per stage and per NTT;
   b. `NTTDomain.ntt`, `intt` and four-step `ntt`: table build timed
      apart, intt(ntt(x)) == x, four-step equal to radix-2, three outputs
      against sum_j x_j g^(j k) in Python ints, launches per transform
      (K1 and K5 must be > 0), three timed calls each;
   c. polynomials: `mul_ntt` of two 2^19-coefficient polynomials checked
      at a random point, `eval_at` and `quot_by_vanishing` (the KZG
      opening's steps) against Python Horner evaluations;
   d. group FFT over G1 at 2^14 (the seeds tiled): `fft` at two outputs
      against `msm_std` with scalars w^(j k), ifft(fft(P)) == P.

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
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEEDS = {grp: os.path.join(ROOT, "bench_data", f"seeds_BLS12_381_{grp}.npz")
         for grp in ("g1", "g2")}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
IMAD_PER_CLOCK_PER_SM = 64         # compute capability 9.0, 32-bit multiply-add
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
        plain_ms = time_ms(lambda: kernel_field.mont_mul_plain(a, b, f), 2,
                           device)
        nbytes = 3 * 4 * f.W * n
        nops = n * (4 * f.W * f.W + f.W)
        b_ms, b_by = bound(nbytes, nops, int_rate)
        log(f"# K1 mont_mul {prm.name} W={f.W} n={n}: equal to plain; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes} B, {nops} IMAD)")
        by_width.append(dict(W=f.W, field=prm.name, n=n, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=err))
        if prm is P.BLS12_381_FP:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
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
        f"passes): equal to plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, torch.sort + gather {library_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes} B); pass kernel {json.dumps(occ)}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, max_abs_err=err,
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
    ncomp = 1 if grp == "g1" else 2
    nbytes, nops, madds = scan_work(ck.fp, ncomp, gpts, sd, idx, m, nbuckets)
    b_ms, b_by = bound(nbytes, nops, int_rate)
    scope = ("all windows" if windows is None else
             f"windows {rows} of 0..{nwin - 1}")
    log(f"# {k} bucket_scan {grp} c={c} windows={nwin} n={n} block={m}: "
        f"buckets and trailers equal to plain {how} on {scope}; kernel "
        f"{ms:.3f} ms (all windows), plain {plain_ms:.1f} ms ({scope}), "
        f"bound {b_ms:.3f} ms ({b_by}: {madds} madds, {nops} IMAD, {nbytes} "
        f"B); {json.dumps(occ)}")
    return dict(ms=ms, plain_ms=plain_ms, plain_scope=scope, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, max_abs_err=err,
                compared=how, shape=f"{nwin} windows x {n} points, block {m}",
                **occ)


def counters():
    from zikkurat_algebra_tpu_torch.ops import (kernel_curve, kernel_field,
                                                kernel_ntt, kernel_sort)

    return {"mont_mul": kernel_field.mont_mul,
            "ntt_stage": kernel_ntt.ntt_stage,
            "bucket_scan": kernel_curve.bucket_scan,
            "bucket_scan2": kernel_curve.bucket_scan2,
            "sort_key_val": kernel_sort.sort_key_val}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts(device, path, need):
    """The launch counts since `reset_counts`; each kernel in `need` must
    have been launched (on a card)."""
    launches = {name: fn.launches for name, fn in counters().items()}
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
    cols = k_np.view(np.uint32).astype(np.uint64).reshape(
        k_np.shape[0], n // nseed, nseed).sum(1)
    folded = [v % og.r for v in limbs_to_ints(cols_to_limbs(cols))]
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


def horner(coeffs, z: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % p
    return acc


def phase_k5(device, log_n, int_rate, rng):
    """K5 over one full radix-2 NTT of 2^log_n random Fr elements against
    its plain version, stage by stage; times per stage and per NTT."""
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops import kernel_ntt
    from zikkurat_algebra_tpu_torch.ops.field import Field
    from zikkurat_algebra_tpu_torch.ops.ntt import NTTDomain

    f = Field(P.BLS12_381_FR, device)
    n = 1 << log_n
    dom = NTTDomain(f, log_n)
    tables = dom.tables()
    x = torch.from_numpy(rand_canonical(rng, f.p, f.W, n)).to(device)
    y0 = x.index_select(1, dom.perm()).reshape(f.W, 1, n, 1).contiguous()
    yk, yp = y0.clone(), y0.clone()
    err = 0
    for s, tw in enumerate(tables, 1):
        kernel_ntt.ntt_stage(yk, tw, s, f)
        kernel_ntt.ntt_stage_plain(yp, tw, s, f)
        err = max(err, max_limb_diff(yk, yp))
        if err:
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"stage {s}: max |limb diff| {err}")
    buf = y0.clone()
    stage_ms = [time_ms(lambda: kernel_ntt.ntt_stage(buf, tw, s, f), 20,
                        device) for s, tw in enumerate(tables, 1)]

    def plain_ntt():
        for s, tw in enumerate(tables, 1):
            kernel_ntt.ntt_stage_plain(buf, tw, s, f)

    plain_ms = time_ms(plain_ntt, 1, device) / log_n
    ms = sum(stage_ms) / log_n
    # per stage: x read and written once, the table read once; one
    # Montgomery product (4 W^2 + W multiply-adds) per pair
    nbytes = [2 * 4 * f.W * n + 4 * f.W * (1 << (s - 1))
              for s in range(1, log_n + 1)]
    nops = (n // 2) * (4 * f.W * f.W + f.W)
    bounds = [bound(b, nops, int_rate) for b in nbytes]
    b_ms = sum(b for b, _ in bounds) / log_n
    b_by = bounds[-1][1]
    t_bytes = sum(nbytes) / log_n / HBM_BYTES_PER_S * 1e3
    t_ops = nops / int_rate * 1e3
    log(f"# K5 ntt_stage BLS12-381/Fr n=2^{log_n}: all {log_n} stages equal "
        f"to plain; kernel {ms:.4f} ms per stage, {sum(stage_ms):.3f} ms "
        f"per NTT; plain {plain_ms:.3f} ms per stage; bound {b_ms:.4f} ms "
        f"per stage, {b_ms * log_n:.3f} ms per NTT ({b_by}: bytes "
        f"{t_bytes:.4f} ms, operations {t_ops:.4f} ms per stage; "
        f"{nops} IMAD per stage)")
    log("# K5 ms by stage: " + ", ".join(f"{v:.4f}" for v in stage_ms))
    return dict(ms=ms, ms_per_ntt=sum(stage_ms), stage_ms=stage_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_ms_per_ntt=b_ms * log_n, bytes_ms=t_bytes,
                operations_ms=t_ops, library_ms=None, max_abs_err=err,
                shape=f"(8, 1, 2^{log_n}, 1) BLS12-381/Fr, one stage")


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
    launches = read_counts(device, "group FFT", ("mont_mul",))
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

    def call(name, fn):
        before = {k: c.launches for k, c in counters().items()}
        out = fn()
        sync(device)
        per[name] = {k: c.launches - before[k] for k, c in counters().items()
                     if c.launches != before[k]}
        if device.type == "cuda" and not per[name].get("mont_mul"):
            raise AssertionError(f"{name}: K1 was not launched")
        for k, v in per[name].items():
            total[k] = total.get(k, 0) + v
        _, times[name] = timed(fn, device)
        return out

    def check_group(grp, n, enc, dec_x, comp, decomp, ops, og, osqrt, ornd):
        _, _, pts = tiled_seeds(ck, grp, n, device)
        x, flags = comp(pts)
        (xd, yd, infd), valid = call(f"decompress_{grp}",
                                     lambda: decomp(x, flags))
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
        root, ok = call(f"sqrt {f.params.name}", lambda: f.sqrt(sq))
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
        srs_log_n: int = 20, srs_g2_log_n: int = 12):
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
                                        "bucket_scan2"))}

    # the G1 path
    seeds, nseed, pts = tiled_seeds(ck, "g1", n, device)
    k_np = rand_canonical(rng, ck.fr.p, ck.fr.W, n)
    meas["bucket_scan"] = phase_scan(ck, "g1", torch.from_numpy(k_np).to(
        device), pts, int_rate, device, block, sms)
    launches["g1"] = phase_msm(ck, "g1", k_np, pts, seeds, nseed, device,
                               block, ("mont_mul", "sort_key_val",
                                       "bucket_scan"))

    # the SRS path: decompression, subgroup checks, square roots
    launches["srs"], meas["mont_mul"]["srs_path"] = phase_srs(
        ck, device, srs_log_n, srs_g2_log_n, srs_log_n, rng)

    # the NTT, polynomial and group-FFT path
    meas["ntt_stage"] = phase_k5(device, ntt_log_n, int_rate, rng)
    launches["ntt"], meas["ntt_stage"]["ntt_path"] = phase_ntt(
        device, ntt_log_n, rng)
    launches["poly"], meas["ntt_stage"]["poly_ms"] = phase_poly(
        device, ntt_log_n, rng)
    launches["gfft"], meas["ntt_stage"]["gfft_ms"] = phase_gfft(
        ck, device, gfft_log_n, block, rng)

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
