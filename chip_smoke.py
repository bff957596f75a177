"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

The main paths are the BLS12-381 G2 and G1 Pippenger MSMs of 2^20 points
(zikkurat_algebra_tpu_torch, `CurveKernels(...).msm(grp).msm_std`, c from
`window_size`, block 512).  The script

1. prints the card and its power limit, builds the four CUDA kernels from
   the sources in this checkout (one nvcc per source, in parallel) and
   prints the registers and spills `-Xptxas -v` reports;
2. holds kernel K1 (Montgomery product) against its plain torch version
   on 2^20 random elements of BLS12-381 Fp, BLS12-381 Fr and BN128 Fp:
   exact limb equality; times both;
3. G2 path, on the 1024 committed seeds of
   bench_data/seeds_BLS12_381_g2.npz (tiled) and random scalars:
   a. K3 (grouping sort) against its plain version on the path's own
      |digit| rows, exact; times the kernel, the plain version and
      torch.sort;
   b. K4 (Fp2 bucket accumulation) on the path's own inputs at block 512;
      its buckets and trailers are held exactly against the plain version
      on two of the windows (the first and the carry window), at full n
      and full block; times both;
   c. the MSM: a 2^6-prefix check and a folded full-size check against
      the oracle, the launches of every kernel in that run (K1, K3 and K4
      must be > 0), then three timed runs with per-stage times and peak
      device memory;
4. G1 path, the same on bench_data/seeds_BLS12_381_g1.npz: K2 against its
   plain version on all windows, then the MSM (K1, K2 and K3 must be
   launched).

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
    """{entry label: (registers, spill store + load bytes)} from the
    -Xptxas -v log of one source."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = kernel_label(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            regs = out.get(cur, (None, 0))[0]
            out[cur] = (regs, int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), out.get(cur, (None, 0))[1])
    return out


def phase_build():
    from zikkurat_algebra_tpu_torch.utils import build

    t = time.perf_counter()
    secs = build.build(src for src, _ in KERNELS.values())
    log(f"# build: {time.perf_counter() - t:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    regs = {}
    for name, (src, _) in KERNELS.items():
        rep = ptxas_report(build.log_path(src).read_text())
        regs[name] = {k: {"registers": r, "spill_bytes": s}
                      for k, (r, s) in rep.items()}
        for k, (r, s) in rep.items():
            log(f"# ptxas {src} {k}: {r} registers, {s} bytes spilled")
    return regs


def phase_k1(device, n, int_rate, rng):
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops import kernel_field
    from zikkurat_algebra_tpu_torch.ops.field import Field

    row = None
    for prm in (P.BLS12_381_FP, P.BLS12_381_FR, P.BN128_FP):
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
        log(f"# K1 mont_mul {prm.name} n={n}: equal to plain; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {nbytes} B, {nops} IMAD)")
        if prm is P.BLS12_381_FP:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err, shape=f"({f.W}, {n}) {prm.name}")
    return row


def phase_k3(msm, k_limbs, device, block):
    """K3 on the path's own |digit| rows against its plain version."""
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
        f"passes): equal to plain; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms, torch.sort + gather {library_ms:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes} B; {passes} passes move {passes * nbytes} B)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, max_abs_err=err,
                shape=f"{wc} rows x {n}, key_bits {bits}")


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


def phase_scan(ck, grp, k_limbs, pts, int_rate, device, m, windows=None):
    """K2 (G1) or K4 (G2) on the path's own inputs against the plain
    version, on all windows or on the listed ones."""
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
    err = max_limb_diff(tuple(tuple(c[..., rows, :] for c in p) for p in got),
                        want)
    if err:
        raise AssertionError(f"{k} differs from its plain version: max |limb "
                             f"diff| {err}")
    ms = time_ms(lambda: kernel_curve.bucket_scan(ops, *args), 3, device)
    ncomp = 1 if grp == "g1" else 2
    nbytes, nops, madds = scan_work(ck.fp, ncomp, gpts, sd, idx, m, nbuckets)
    b_ms, b_by = bound(nbytes, nops, int_rate)
    scope = ("all windows" if windows is None else
             f"windows {rows} of 0..{nwin - 1}")
    log(f"# {k} bucket_scan {grp} c={c} windows={nwin} n={n} block={m} "
        f"lanes={nwin * n // m}: buckets and trailers equal to plain on "
        f"{scope}; kernel {ms:.3f} ms (all windows), plain {plain_ms:.1f} ms "
        f"({scope}), bound {b_ms:.3f} ms ({b_by}: {madds} madds, {nops} "
        f"IMAD, {nbytes} B)")
    return dict(ms=ms, plain_ms=plain_ms, plain_scope=scope, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, max_abs_err=err,
                shape=f"{nwin} windows x {n} points, block {m}")


def counters():
    from zikkurat_algebra_tpu_torch.ops import (kernel_curve, kernel_field,
                                                kernel_sort)

    return {"mont_mul": kernel_field.mont_mul,
            "bucket_scan": kernel_curve.bucket_scan,
            "bucket_scan2": kernel_curve.bucket_scan2,
            "sort_key_val": kernel_sort.sort_key_val}


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
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    t = time.perf_counter()
    res = msm.msm_std(k_limbs, pts, None, block)
    aff = ops.to_affine(res)
    sync(device)
    first_s = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in cnt.items()}
    t = time.perf_counter()
    want = og.msm(folded, seeds)
    oracle_s = time.perf_counter() - t
    if decode(aff) != want:
        raise AssertionError(f"{grp} MSM folded full-size check vs the oracle "
                             "FAILED")
    log(f"# {grp} MSM check (b): full 2^{n.bit_length() - 1} MSM equals the "
        f"oracle MSM of the {nseed} seeds with folded scalars "
        f"({first_s:.2f} s incl. to_affine; oracle {oracle_s:.1f} s)")
    log(f"# launches in that {grp} MSM + to_affine: {json.dumps(launches)}")
    for name in need:
        if launches[name] == 0 and device.type == "cuda":
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{grp} path")

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
        block: int = 512):
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
    rng = np.random.default_rng(20)
    meas = {"mont_mul": phase_k1(device, 1 << k1_log_n, int_rate, rng)}
    ck = CurveKernels(P.BLS12_381, device)

    # the G2 path
    n = 1 << log_n
    seeds, nseed, pts = tiled_seeds(ck, "g2", n, device)
    k_np = rand_canonical(rng, ck.fr.p, ck.fr.W, n)
    k_limbs = torch.from_numpy(k_np).to(device)
    meas["sort_key_val"] = phase_k3(ck.msm("g2"), k_limbs, device, block)
    meas["bucket_scan2"] = phase_scan(ck, "g2", k_limbs, pts, int_rate,
                                      device, block, windows=(0, -1))
    launches = {"g2": phase_msm(ck, "g2", k_np, pts, seeds, nseed, device,
                                block, ("mont_mul", "sort_key_val",
                                        "bucket_scan2"))}

    # the G1 path
    seeds, nseed, pts = tiled_seeds(ck, "g1", n, device)
    k_np = rand_canonical(rng, ck.fr.p, ck.fr.W, n)
    meas["bucket_scan"] = phase_scan(ck, "g1", torch.from_numpy(k_np).to(
        device), pts, int_rate, device, block)
    launches["g1"] = phase_msm(ck, "g1", k_np, pts, seeds, nseed, device,
                               block, ("mont_mul", "sort_key_val",
                                       "bucket_scan"))

    rows = []
    for name, (src, rep) in KERNELS.items():
        row = dict(name=name, route="cuda",
                   source=f"zikkurat_algebra_tpu_torch/csrc/{src}.cu",
                   replaces=rep,
                   launches=launches["g2"][name] + launches["g1"][name],
                   launches_g2=launches["g2"][name],
                   launches_g1=launches["g1"][name], library_ms=None,
                   ptxas=regs.get(name, {}))
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
