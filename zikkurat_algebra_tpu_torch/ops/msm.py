"""Pippenger multi-scalar multiplication on G1 and G2.

The torch counterpart of zikkurat_algebra_tpu/ops/msm.py::MSM.msm_std and
CurveMSM.msm_mont.  Every stage is generic over the coordinate field: it
reads `ops.f.struct_ndim` leading axes, one for Fp (G1), two for Fp2
(G2).

`msm_std` takes scalars (Wr, N) for one MSM, or (Wr, B, N) for B MSMs
over the same N points, which run as one: every stage below works on
rows, and a row is one (scalar vector, window) pair, ordered by scalar
vector, then window (B nwin rows; nwin rows for (Wr, N)).  The stages,
in order:

1. signed window digits (`digits_from_limbs`, `signed_digits`): c-bit
   windows made balanced, |digit| <= 2^(c-1), plus one carry window,
   laid out as the rows;
2. padding to a multiple of the block with digit = nbuckets (a dump
   slot) and points at infinity;
3. grouping: kernel K3 (`kernel_sort.sort_key_val`), a stable sort of
   |digit| along each row carrying the position index, one launch for
   all rows;
4. level 1, kernel K2 for G1 or K4 for G2 (`kernel_curve.bucket_scan`):
   per-block running mixed-add chains over all rows and the shared
   points, written out at segment tails and block ends;
5. level 2 (`_level2_carries`): the trailers of consecutive blocks that
   one digit spans are combined by a log-depth segmented scan;
6. extraction: each carry is added into the bucket where its segment
   ends; bucket 0 and the dump slot are dropped;
7. `_weighted_bucket_sum`: sum_b b * bucket_b per row;
8. Horner: res = 2^c res + W_w from the top window down, at batch B.

On the card every G1 point addition and doubling is one launch of
`csrc/point_ops.cu` (at batch B in Horner, not B chains); every other
field product goes through kernel K1.

Each stage is a span of `utils.profiling` (`msm.digits` ... `msm.horner`
inside `msm.std`); `stage_seconds` collects their device intervals.  The
counter `msm_scalar_sets` adds B per call (1 for scalars (Wr, N)).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..errors import DimensionError
from ..utils import profiling as prof
from . import limbs as lb
from .curve import AffBatch, Point, ProjCurveOps
from .kernel_curve import bucket_scan
from .kernel_sort import sort_key_val


STAGES = ("digits", "sort", "bucket_scan", "level2", "extraction",
          "weighted_sum", "horner")
_STAGE_SPANS = {f"msm.{s}": s for s in STAGES}


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


def _mid(ops: ProjCurveOps, P: Point) -> tuple:
    """The batch axes of P's coordinates before the last one."""
    return P[0].shape[ops.f.struct_ndim:-1]


def _shift_in(P: Point, ops: ProjCurveOps, s: int) -> Point:
    """Move points s places along the last axis, infinity coming in."""
    inf = ops.infinity(_mid(ops, P) + (s,))
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
            inf = ops.infinity(_mid(ops, P) + (1,))
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
    inf = ops.infinity(shape[ops.f.struct_ndim:])
    U = _tree_sum(ops, ops.select(mask, Tx, inf))
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
        inf = ops.infinity(_mid(ops, S) + (H * M - B,))
        S = tuple(torch.cat([s, i], -1) for s, i in zip(S, inf))
    G = tuple(s.reshape(s.shape[:-1] + (H, M)) for s in S)
    R = _tree_sum(ops, G)
    C = _tree_sum(ops, tuple(g.transpose(-1, -2) for g in G))
    Whi = _wsum_bits(ops, R, 0)
    for _ in range(k):
        Whi = ops.dbl(Whi)
    return ops.add(Whi, _wsum_bits(ops, C, 1))


class MSM:
    """Pippenger MSM bound to one curve group (G1 or G2)."""

    def __init__(self, ops: ProjCurveOps, nbits: int):
        self.ops = ops
        self.nbits = nbits

    def digits(self, k_limbs: torch.Tensor, c: int, block: int):
        """Stages 1-2 for the scalars (Wr, N) or (Wr, B, N): signed digits
        (nwin, n) or (B nwin, n), row b nwin + w holding window w of
        scalar vector b, padded to a multiple of the block with the dump
        key nbuckets."""
        nbuckets = (1 << (c - 1)) + 1
        sdig = signed_digits(digits_from_limbs(k_limbs, c, self.nbits), c)
        sdig = sdig.movedim(0, -2).reshape(-1, sdig.shape[-1])
        pad = (-sdig.shape[1]) % block
        if pad:
            sdig = torch.cat(
                [sdig, sdig.new_full((sdig.shape[0], pad), nbuckets)], 1)
        return sdig

    def group(self, k_limbs: torch.Tensor, points: AffBatch,
              c: Optional[int] = None, block: int = 512,
              stage_seconds: Optional[Dict[str, float]] = None):
        """Stages 1-3: signed digits, padding and the grouping sort.
        Returns (c, nbuckets, (x, y, inf), sd, idx): the padded points and
        the sorted signed digits (rows as `digits` lays them out) with the
        index of each position's point, which is what kernels K2 and K4
        take."""
        n = k_limbs.shape[-1]
        if k_limbs.ndim not in (2, 3):
            raise DimensionError(
                f"scalars of shape {tuple(k_limbs.shape)}, not (Wr, N) or "
                "(Wr, B, N)")
        if points[0].shape[-1] != n or points[1].shape[-1] != n:
            raise DimensionError(
                f"incompatible array dimensions: {n} scalars vs "
                f"{points[0].shape[-1]} points"
            )
        if block < 1:
            raise ValueError(f"block must be positive, not {block}")
        if c is None:
            c = window_size(n)
        nbuckets = (1 << (c - 1)) + 1
        with prof.stages(stage_seconds, _STAGE_SPANS):
            with prof.span("msm.digits", k_limbs):
                sdig = self.digits(k_limbs, c, block)
                x, y, inf = points
                pad = sdig.shape[1] - n
                if pad:
                    x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], -1)
                    y = torch.cat([y, y.new_zeros(y.shape[:-1] + (pad,))], -1)
                    inf = torch.cat([inf, inf.new_ones(pad)])

            # K3 sorts |digit| along each row, carrying the position index
            with prof.span("msm.sort", k_limbs):
                rows, npad = sdig.shape
                pos = torch.arange(npad, dtype=torch.int32,
                                   device=sdig.device)
                _, (idx,) = sort_key_val(
                    sdig.abs(), pos.expand(1, rows, npad).contiguous(),
                    nbuckets.bit_length())
                sd = torch.gather(sdig, 1, idx.long())
        pts = (x.contiguous(), y.contiguous(), inf.contiguous())
        return c, nbuckets, pts, sd, idx

    def msm_std(self, k_limbs: torch.Tensor, points: AffBatch,
                c: Optional[int] = None, block: int = 512,
                stage_seconds: Optional[Dict[str, float]] = None) -> Point:
        """sum_i k_i P_i for canonical standard-rep scalar limbs (Wr, N)
        and affine points (x, y, inf), x and y (W, N) over Fp or
        (W, 2, N) over Fp2; returns one projective point.  Scalars
        (Wr, B, N) give the B sums over the same points in one pass, a
        projective point of batch (B,).
        `stage_seconds`, when given, adds each stage's device interval
        (`STAGES`), the call recording its spans; the card is waited on
        once, after the call."""
        ops = self.ops
        lead = tuple(k_limbs.shape[1:-1])          # () or (B,)
        with prof.stages(stage_seconds, _STAGE_SPANS), \
                prof.span("msm.std", k_limbs):
            c, nbuckets, (x, y, inf), sd, idx = self.group(
                k_limbs, points, c, block)
            sets = math.prod(lead)
            prof.count("msm_scalar_sets", sets)
            rows, n = sd.shape
            nwin = rows // sets

            with prof.span("msm.bucket_scan"):
                buckets, S = bucket_scan(ops, x, y, inf, sd, idx, block,
                                         nbuckets)

            with prof.span("msm.level2"):
                a = sd.abs().view(rows, n // block, block)
                C, cidx = _level2_carries(ops, a[..., 0], a[..., -1], S,
                                          nbuckets)

            with prof.span("msm.extraction"):
                ri = torch.arange(rows, device=cidx.device)[:, None]
                fixed = ops.add(tuple(b[..., ri, cidx] for b in buckets), C)
                for b, v in zip(buckets, fixed):
                    b[..., ri, cidx] = v
                buckets = tuple(b[..., 1:nbuckets] for b in buckets)

            with prof.span("msm.weighted_sum"):
                Ws = tuple(w.unflatten(-1, lead + (nwin,))
                           for w in _weighted_bucket_sum(ops, buckets))

            with prof.span("msm.horner"):
                res = tuple(w[..., nwin - 1] for w in Ws)
                for wi in range(nwin - 2, -1, -1):
                    for _ in range(c):
                        res = ops.dbl(res)
                    res = ops.add(res, tuple(w[..., wi] for w in Ws))
        return res


class CurveMSM(MSM):
    """MSM with the scalar field attached (Montgomery-form scalars)."""

    def __init__(self, ops: ProjCurveOps, fr):
        super().__init__(ops, fr.p.bit_length())
        self.fr = fr

    def msm_mont(self, k_mont: torch.Tensor, points: AffBatch,
                 c: Optional[int] = None, block: int = 512,
                 stage_seconds: Optional[Dict[str, float]] = None) -> Point:
        return self.msm_std(self.fr.from_mont(k_mont), points, c, block,
                            stage_seconds)
