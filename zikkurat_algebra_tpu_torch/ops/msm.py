"""Pippenger multi-scalar multiplication on G1.

The torch counterpart of zikkurat_algebra_tpu/ops/msm.py::MSM.msm_std and
CurveMSM.msm_mont.  The stages, in order:

1. signed window digits (`digits_from_limbs`, `signed_digits`): c-bit
   windows made balanced, |digit| <= 2^(c-1), plus one carry window;
2. padding to a multiple of the block with digit = nbuckets (a dump
   slot) and points at infinity;
3. grouping: `torch.sort(stable=True)` of |digit| along each window row;
4. level 1, kernel K2 (`kernel_curve.bucket_scan`): per-block running
   mixed-add chains, written out at segment tails and block ends;
5. level 2 (`_level2_carries`): the trailers of consecutive blocks that
   one digit spans are combined by a log-depth segmented scan;
6. extraction: each carry is added into the bucket where its segment
   ends; bucket 0 and the dump slot are dropped;
7. `_weighted_bucket_sum`: sum_b b * bucket_b per window;
8. Horner: res = 2^c res + W_w from the top window down.

Every field product inside goes through kernel K1.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from ..errors import DimensionError
from . import limbs as lb
from .curve import AffBatch, Point, ProjCurveOps
from .kernel_curve import bucket_scan


def window_size(n: int) -> int:
    """c = round(log2 n - 3.5), clamped to [1, 15] (msm.py:58)."""
    if n <= 1:
        return 1
    c = round(math.log2(n) - 3.5)
    return max(1, min(15, c))


def digits_from_limbs(k_limbs: torch.Tensor, c: int, nbits: int
                      ) -> torch.Tensor:
    """Canonical standard-rep scalar limbs (Wr, N) -> unsigned c-bit window
    digits (ceil(nbits / c), N) int32, least significant window first."""
    windows = -(-nbits // c)
    x = lb.to64(k_limbs)
    x = torch.cat([x, torch.zeros_like(x[:2])], 0)
    off = torch.arange(windows, device=x.device) * c
    q, s = off // 32, (off % 32).view(-1, *([1] * (x.ndim - 1)))
    mask = (1 << c) - 1
    lo = x[q] >> s
    hi = (x[q + 1] & mask) << (32 - s)
    return ((lo | hi) & mask).to(torch.int32)


def signed_digits(digits: torch.Tensor, c: int) -> torch.Tensor:
    """Unsigned c-bit digits (Wd, N) -> balanced digits in
    [-2^(c-1), 2^(c-1)] with one carry window appended, (Wd + 1, N);
    sum_w d_w 2^(c w) is preserved."""
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(digits[0])
    out = []
    for d in digits:
        t = d + carry
        neg = t > half
        out.append(torch.where(neg, t - full, t))
        carry = neg.to(torch.int32)
    out.append(carry)
    return torch.stack(out)


def _shift_in(P: Point, ops: ProjCurveOps, s: int) -> Point:
    """Move points s places along the last axis, infinity coming in."""
    inf = ops.infinity(P[0].shape[1:-1] + (s,))
    return tuple(torch.cat([i, p[..., :-s]], -1) for p, i in zip(P, inf))


def _level2_carries(ops: ProjCurveOps, a_first, a_last, S: Point,
                    nbuckets: int):
    """Cross-block carries (msm.py:309).  a_first / a_last: (nwin, nblk)
    |digit| at each block's first and last position; S: the trailers.
    Returns the carry C into each block and the bucket it lands in (the
    block where the spanning segment ends; nbuckets where there is none)."""
    nwin, nblk = a_first.shape
    uniform = a_first == a_last
    conn = torch.zeros_like(uniform)
    conn[:, 1:] = a_first[:, 1:] == a_last[:, :-1]
    # T_b = S_b + [uniform_b & conn_b] T_{b-1}: Hillis-Steele segmented scan
    brk = ~(uniform & conn)
    T = S
    s = 1
    while s < nblk:
        summed = ops.add(_shift_in(T, ops, s), T)
        T = ops.select(brk, T, summed)
        brk = brk | torch.cat([torch.zeros_like(brk[:, :s]), brk[:, :-s]], 1)
        s *= 2
    C = ops.select(conn, _shift_in(T, ops, 1), ops.infinity((nwin, nblk)))
    conn_next = torch.cat([conn[:, 1:], torch.zeros_like(conn[:, :1])], 1)
    ends_here = conn & (~uniform | ~conn_next)
    cidx = torch.where(ends_here, a_first, torch.full_like(a_first, nbuckets))
    return C, cidx


def _tree_sum(ops: ProjCurveOps, P: Point) -> Point:
    """Sum points along the last axis by repeated halving."""
    while P[0].shape[-1] > 1:
        n = P[0].shape[-1]
        if n % 2:
            inf = ops.infinity(P[0].shape[1:-1] + (1,))
            P = tuple(torch.cat([p, i], -1) for p, i in zip(P, inf))
            n += 1
        h = n // 2
        P = ops.add(tuple(p[..., :h] for p in P), tuple(p[..., h:] for p in P))
    return tuple(p[..., 0] for p in P)


def _wsum_bits(ops: ProjCurveOps, T: Point, start: int) -> Point:
    """sum_j (j + start) T_j over the last axis: one masked tree sum per
    bit of the weight, then a Horner pass over the bits."""
    L = T[0].shape[-1]
    nb = (L - 1 + start).bit_length()
    w = torch.arange(L, device=T[0].device) + start
    bits = torch.arange(nb, device=T[0].device)
    mask = ((w[None] >> bits[:, None]) & 1).bool()              # (nb, L)
    shape = T[0].shape[:-1] + (nb, L)
    Tx = tuple(t.unsqueeze(-2).expand(shape) for t in T)
    U = _tree_sum(ops, ops.select(mask, Tx, ops.infinity(shape[1:])))
    acc = tuple(u[..., nb - 1] for u in U)
    for i in range(nb - 2, -1, -1):
        acc = ops.add(ops.dbl(acc), tuple(u[..., i] for u in U))
    return acc


def _weighted_bucket_sum(ops: ProjCurveOps, S: Point) -> Point:
    """sum_b (b + 1) S_b over the last axis in about 2B group adds
    (msm.py:166): with b = hi M + lo and M ~ sqrt(B),
    sum = M sum_hi hi R_hi + sum_lo (lo + 1) C_lo for the row sums R and
    the column sums C."""
    B = S[0].shape[-1]
    if B <= 4:
        return _wsum_bits(ops, S, 1)
    k = (B - 1).bit_length() // 2
    M = 1 << k
    H = -(-B // M)
    if H * M != B:
        inf = ops.infinity(S[0].shape[1:-1] + (H * M - B,))
        S = tuple(torch.cat([s, i], -1) for s, i in zip(S, inf))
    G = tuple(s.reshape(s.shape[:-1] + (H, M)) for s in S)
    R = _tree_sum(ops, G)
    C = _tree_sum(ops, tuple(g.transpose(-1, -2) for g in G))
    Whi = _wsum_bits(ops, R, 0)
    for _ in range(k):
        Whi = ops.dbl(Whi)
    return ops.add(Whi, _wsum_bits(ops, C, 1))


class _Stages:
    """Wall time of each MSM stage, the device synchronised at each end."""

    def __init__(self, out: Optional[Dict[str, float]], device):
        self.out = out
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))
        self.t = time.perf_counter()

    def mark(self, name: str):
        if self.out is None:
            return
        self.sync()
        now = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + now - self.t
        self.t = now


class MSM:
    """Pippenger MSM bound to one curve group."""

    def __init__(self, ops: ProjCurveOps, nbits: int):
        self.ops = ops
        self.nbits = nbits

    def group(self, k_limbs: torch.Tensor, points: AffBatch,
              c: Optional[int] = None, block: int = 512,
              stage_seconds: Optional[Dict[str, float]] = None):
        """Stages 1-3: signed digits, padding and the grouping sort.
        Returns (c, nbuckets, (x, y, inf), sd, idx): the padded points and
        the sorted signed digits with the index of each position's point,
        which is what kernel K2 takes."""
        n = k_limbs.shape[-1]
        if points[0].shape[-1] != n or points[1].shape[-1] != n:
            raise DimensionError(
                f"incompatible array dimensions: {n} scalars vs "
                f"{points[0].shape[-1]} points"
            )
        if block < 1:
            raise ValueError(f"block must be positive, not {block}")
        if c is None:
            c = window_size(n)
        st = _Stages(stage_seconds, k_limbs.device)
        nbuckets = (1 << (c - 1)) + 1
        sdig = signed_digits(digits_from_limbs(k_limbs, c, self.nbits), c)
        nwin = sdig.shape[0]
        x, y, inf = points
        pad = (-n) % block
        if pad:
            sdig = torch.cat([sdig, sdig.new_full((nwin, pad), nbuckets)], 1)
            x = torch.cat([x, x.new_zeros((x.shape[0], pad))], 1)
            y = torch.cat([y, y.new_zeros((y.shape[0], pad))], 1)
            inf = torch.cat([inf, inf.new_ones(pad)])
        st.mark("digits")

        _, idx = torch.sort(sdig.abs(), dim=1, stable=True)
        sd = torch.gather(sdig, 1, idx)
        st.mark("sort")
        pts = (x.contiguous(), y.contiguous(), inf.contiguous())
        return c, nbuckets, pts, sd, idx.to(torch.int32)

    def msm_std(self, k_limbs: torch.Tensor, points: AffBatch,
                c: Optional[int] = None, block: int = 512,
                stage_seconds: Optional[Dict[str, float]] = None) -> Point:
        """sum_i k_i P_i for canonical standard-rep scalar limbs (Wr, N)
        and affine points (x, y, inf); returns one projective point.
        `stage_seconds`, when given, collects each stage's wall time."""
        ops = self.ops
        c, nbuckets, (x, y, inf), sd, idx = self.group(
            k_limbs, points, c, block, stage_seconds)
        st = _Stages(stage_seconds, k_limbs.device)
        nwin, n = sd.shape

        buckets, S = bucket_scan(ops, x, y, inf, sd, idx, block, nbuckets)
        st.mark("bucket_scan")

        a = sd.abs().view(nwin, n // block, block)
        C, cidx = _level2_carries(ops, a[..., 0], a[..., -1], S, nbuckets)
        st.mark("level2")

        rows = torch.arange(nwin, device=cidx.device)[:, None]
        fixed = ops.add(tuple(b[:, rows, cidx] for b in buckets), C)
        for b, v in zip(buckets, fixed):
            b[:, rows, cidx] = v
        buckets = tuple(b[..., 1:nbuckets] for b in buckets)
        st.mark("extraction")

        Ws = _weighted_bucket_sum(ops, buckets)
        st.mark("weighted_sum")

        res = tuple(w[..., nwin - 1] for w in Ws)
        for wi in range(nwin - 2, -1, -1):
            for _ in range(c):
                res = ops.dbl(res)
            res = ops.add(res, tuple(w[..., wi] for w in Ws))
        st.mark("horner")
        return res


class CurveMSM(MSM):
    """MSM with the scalar field attached (Montgomery-form scalars)."""

    def __init__(self, ops: ProjCurveOps, fr):
        super().__init__(ops, fr.p.bit_length())
        self.fr = fr

    def msm_mont(self, k_mont: torch.Tensor, points: AffBatch,
                 c: Optional[int] = None, block: int = 512) -> Point:
        return self.msm_std(self.fr.from_mont(k_mont), points, c, block)
