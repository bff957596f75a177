"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

The main path is the BLS12-381 G1 Pippenger MSM of 2^20 points
(zikkurat_algebra_tpu_torch, `CurveKernels(...).msm("g1").msm_std`, c from
`window_size`, block 512).  The script

1. prints the card and its power limit, builds both CUDA kernels from the
   sources in this checkout (one nvcc per source, in parallel) and prints
   what `-Xptxas -v` says of them;
2. holds kernel K1 (Montgomery product) against its plain torch version
   on 2^20 random elements of BLS12-381 Fp, BLS12-381 Fr and BN128 Fp:
   exact limb equality; times both;
3. holds kernel K2 (level-1 bucket accumulation) against its plain torch
   version on the main path's own inputs at block 512: exact equality of
   the buckets and trailers; times both;
4. runs the MSM at full width on the 1024 committed seed points of
   bench_data/seeds_BLS12_381_g1.npz (tiled) and random scalars: a 2^6
   prefix check and a folded full-size check against the oracle, then
   three timed runs with per-stage times, launch counts and peak memory.

It imports torch, numpy and the port, never JAX.  It fails (nonzero exit,
no result line) without a CUDA card, outside a checkout, or when any
check fails.  The last two lines are the kernel table and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEEDS = os.path.join(ROOT, "bench_data", "seeds_BLS12_381_g1.npz")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
IMAD_PER_CLOCK_PER_SM = 64         # compute capability 9.0, 32-bit multiply-add


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


def phase_build():
    from zikkurat_algebra_tpu_torch.utils import build

    t = time.perf_counter()
    secs = build.build(["mont_mul", "block_scan"])
    log(f"# build: {time.perf_counter() - t:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in secs:
        for line in build.log_path(name).read_text().splitlines():
            if "Compiling entry" in line:
                fn = line.split("'")[1]
                w = "W=12" if "ILi12E" in fn else "W=8" if "ILi8E" in fn else fn
                log(f"# ptxas {name} {w}:")
            elif "registers" in line or "spill" in line:
                log(f"#   {line.strip()}")


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
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
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


def k2_work(f, pts, sd, idx, m, nbuckets):
    """Bytes (each input read once, each output written once) and the
    multiply-adds this run's data needs: one madd of 11 products at every
    position that neither restarts nor holds a point at infinity."""
    import torch

    nwin, n = sd.shape
    a = sd.abs()
    restart = torch.ones_like(a, dtype=torch.bool)
    restart[:, 1:] = a[:, 1:] != a[:, :-1]
    restart[:, ::m] = True
    madds = int((~restart & ~pts[2][idx.long()]).sum())
    nops = madds * 11 * (4 * f.W * f.W + f.W)
    npts = pts[0].shape[1]
    nbytes = (2 * 4 * f.W * npts + npts + 8 * nwin * n
              + 3 * 4 * f.W * nwin * (nbuckets + 1 + n // m))
    return nbytes, nops, madds


def phase_k2(ck, k_limbs, pts, int_rate, device, m):
    from zikkurat_algebra_tpu_torch.ops import kernel_curve

    msm = ck.msm("g1")
    c, nbuckets, gpts, sd, idx = msm.group(k_limbs, pts, None, m)
    args = (*gpts, sd, idx, m, nbuckets)
    got = kernel_curve.bucket_scan(ck.g1, *args)
    want, plain_ms = timed(
        lambda: kernel_curve.bucket_scan_plain(ck.g1.plain(), *args), device)
    err = 0
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            err = max(err, int((gc.long() - wc.long()).abs().max()))
    if err:
        raise AssertionError(f"K2 differs from its plain version: max |limb "
                             f"diff| {err}")
    ms = time_ms(lambda: kernel_curve.bucket_scan(ck.g1, *args), 3, device)
    nbytes, nops, madds = k2_work(ck.fp, gpts, sd, idx, m, nbuckets)
    b_ms, b_by = bound(nbytes, nops, int_rate)
    nwin, n = sd.shape
    log(f"# K2 bucket_scan c={c} windows={nwin} n={n} block={m} "
        f"lanes={nwin * n // m}: buckets and trailers equal to plain; kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms "
        f"({b_by}: {madds} madds, {nops} IMAD, {nbytes} B)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err,
                shape=f"{nwin} windows x {n} points, block {m}")


def phase_msm(ck, k_np, pts, seeds_aff, nseed, device, block):
    import torch
    from zikkurat_algebra_tpu_torch.ops import kernel_curve, kernel_field
    from zikkurat_algebra_tpu_torch.ops.limbs import limbs_to_ints

    og = ck.oracle_g1
    msm = ck.msm("g1")
    n = k_np.shape[1]
    k_limbs = torch.from_numpy(k_np).to(device)
    seeds = ck.decode_g1(seeds_aff)

    # (a) the bench.py check: scalars past a 2^6 prefix zeroed, full shape
    m = min(64, n)
    kpre = k_limbs.clone()
    kpre[:, m:] = 0
    got = ck.decode_g1(ck.g1.to_affine(msm.msm_std(kpre, pts, None, block)))
    ks_pre = limbs_to_ints(k_np[:, :m])
    if got != og.msm(ks_pre, [seeds[i % nseed] for i in range(m)]):
        raise AssertionError("MSM prefix check vs the oracle FAILED")
    log(f"# MSM check (a): 2^6-prefix MSM at n={n} equals the oracle")

    # (b) every scalar live: fold the scalars onto the seeds
    cols = k_np.view(np.uint32).astype(np.uint64).reshape(
        k_np.shape[0], n // nseed, nseed).sum(1)
    folded = [v % og.r for v in limbs_to_ints(cols_to_limbs(cols))]
    kernel_field.mont_mul.launches = 0
    kernel_curve.bucket_scan.launches = 0
    t = time.perf_counter()
    res = msm.msm_std(k_limbs, pts, None, block)
    aff = ck.g1.to_affine(res)
    sync(device)
    first_s = time.perf_counter() - t
    launches = {"mont_mul": kernel_field.mont_mul.launches,
                "bucket_scan": kernel_curve.bucket_scan.launches}
    if ck.decode_g1(aff) != og.msm(folded, seeds):
        raise AssertionError("MSM folded full-size check vs the oracle FAILED")
    log(f"# MSM check (b): full 2^{n.bit_length() - 1} MSM equals the "
        f"oracle MSM of the {nseed} seeds with folded scalars "
        f"({first_s:.2f} s incl. to_affine)")
    log(f"# launches in that MSM + to_affine: {json.dumps(launches)}")
    for name, count in launches.items():
        if count == 0 and device.type == "cuda":
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

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
        aff = ck.g1.to_affine(res)
    sync(device)
    stages["to_affine"] = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    log(f"# MSM n={n}: {per_run * 1e3:.1f} ms per msm_std, "
        f"{n / per_run:.1f} points/s over {runs} runs; peak device memory "
        f"{peak} B")
    log("# stage ms (mean of 3): " + ", ".join(
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


def run(device_name: str = "cuda", log_n: int = 20, k1_log_n: int = 20,
        block: int = 512):
    import torch
    from zikkurat_algebra_tpu_torch import params as P
    from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
    from zikkurat_algebra_tpu_torch.utils.convert import load_jax_seed_points

    device = torch.device(device_name)
    card = smi("name,power.limit") if device.type == "cuda" else "cpu"
    log(card)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(0)
        clock_mhz = float(smi("clocks.max.sm").split()[0])
        int_rate = IMAD_PER_CLOCK_PER_SM * props.multi_processor_count \
            * clock_mhz * 1e6
        log(f"# {props.multi_processor_count} SMs, max SM clock {clock_mhz} "
            f"MHz: int32 multiply-add peak {int_rate:.4g}/s")
        phase_build()
    else:
        int_rate = IMAD_PER_CLOCK_PER_SM * 132 * 1980e6
    rng = np.random.default_rng(20)

    k1 = phase_k1(device, 1 << k1_log_n, int_rate, rng)

    ck = CurveKernels(P.BLS12_381, device)
    n = 1 << log_n
    seeds_aff = load_jax_seed_points(SEEDS, ck.fp)
    nseed = seeds_aff[0].shape[1]
    reps = -(-n // nseed)
    pts = (seeds_aff[0].repeat(1, reps)[:, :n].contiguous(),
           seeds_aff[1].repeat(1, reps)[:, :n].contiguous(),
           seeds_aff[2].repeat(reps)[:n].contiguous())
    k_np = rand_canonical(rng, ck.fr.p, ck.fr.W, n)
    k2 = phase_k2(ck, torch.from_numpy(k_np).to(device), pts, int_rate,
                  device, block)
    launches = phase_msm(ck, k_np, pts, seeds_aff, nseed, device, block)

    rows = []
    for name, src, rep, meas in (
        ("mont_mul", "zikkurat_algebra_tpu_torch/csrc/mont_mul.cu",
         "zikkurat_algebra_tpu/ops/pallas_field.py:94", k1),
        ("bucket_scan", "zikkurat_algebra_tpu_torch/csrc/block_scan.cu",
         "zikkurat_algebra_tpu/ops/pallas_curve.py:241", k2),
    ):
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=launches[name], library_ms=None, **meas))
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
