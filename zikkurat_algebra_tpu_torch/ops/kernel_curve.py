"""Kernel K2: level-1 bucket accumulation of the MSM, and its plain version.

`bucket_scan` runs one lane per (window, block) of the sorted digit rows.
Each lane streams through the m positions of its block and keeps a
running projective sum:

    acc = restart ? from_affine(pt) : madd(acc, pt)

where pt is the point of that position (gathered by its index, y negated
for a negative digit, the identity if the point is at infinity), madd is
RCB15 algorithm 8, and a lane restarts at its first position and wherever
the digit changes.  It writes only what the MSM reads afterwards:

* the running value at each segment's global tail (the last position of
  a digit in the whole row) into bucket[w, digit] -- each (window, digit)
  has exactly one global tail, so no two lanes write the same slot;
* the running value at each block's last position, the trailer S[w, blk]
  that the level-2 carries combine across blocks.

Buckets that no tail writes stay at infinity.  On a CUDA tensor the
wrapper launches the hand-written kernel of `csrc/block_scan.cu`; on a CPU
tensor it runs `bucket_scan_plain`.

It replaces the Pallas kernel `_build_block_scan` / `block_madd_scan` of
zikkurat_algebra_tpu/ops/pallas_curve.py, which streams a packed sort
payload and writes every running value, because the TPU has no gather.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from .curve import ProjCurveOps


def _check(ops: ProjCurveOps, x, y, inf, sd, idx, m: int, nbuckets: int):
    W = ops.f.W
    if x.dtype != torch.int32 or y.dtype != torch.int32:
        raise TypeError("bucket_scan: x and y are int32 limb planes")
    if x.ndim != 2 or x.shape[0] != W or y.shape != x.shape:
        raise ValueError(f"bucket_scan: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, want ({W}, npts)")
    if inf.dtype != torch.bool or inf.shape != (x.shape[1],):
        raise ValueError("bucket_scan: inf is a (npts,) bool mask")
    if sd.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("bucket_scan: digits and indices are int32")
    if sd.ndim != 2 or idx.shape != sd.shape or sd.shape[1] % m:
        raise ValueError(f"bucket_scan: digits {tuple(sd.shape)}, indices "
                         f"{tuple(idx.shape)}, block {m}")
    if nbuckets < 1:
        raise ValueError("bucket_scan: nbuckets must be positive")
    devs = {t.device for t in (x, y, inf, sd, idx)} | {ops.f.device}
    if len(devs) != 1:
        raise ValueError(f"bucket_scan: tensors on several devices {devs}")


def bucket_scan_plain(ops: ProjCurveOps, x, y, inf, sd, idx, m: int,
                      nbuckets: int):
    """Plain torch version: a loop over the m block positions, each a
    batched madd over all (window, block) lanes."""
    f = ops.f
    nwin, n = sd.shape
    nblk = n // m
    a = sd.abs()
    nxt = torch.cat([a[:, 1:], torch.full_like(a[:, :1], -1)], 1)
    tail = (nxt != a).view(nwin, nblk, m)
    a = a.view(nwin, nblk, m)
    neg = (sd < 0).view(nwin, nblk, m)
    ii = idx.long().view(nwin, nblk, m)
    rows = torch.arange(nwin, device=sd.device)[:, None].expand(nwin, nblk)
    buckets = ops.infinity((nwin, nbuckets + 1))
    acc = ops.infinity((nwin, nblk))
    for j in range(m):
        i = ii[..., j]
        py = y[:, i]
        pt = (x[:, i], f.select(neg[..., j], f.neg(py), py), inf[i])
        restart = (torch.ones_like(neg[..., 0]) if j == 0
                   else a[..., j] != a[..., j - 1])
        acc = ops.select(restart, ops.from_affine(pt), ops.madd(acc, pt))
        t = tail[..., j]
        wi, ai = rows[t], a[..., j][t]
        for b, v in zip(buckets, acc):
            b[:, wi, ai] = v[:, t]
    return buckets, acc


_ARGTYPES = [ctypes.c_void_p] * 12 + [
    ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def bucket_scan(ops: ProjCurveOps, x, y, inf, sd, idx, m: int,
                nbuckets: int):
    """Level-1 bucket accumulation.

    x, y: (W, npts) canonical Montgomery affine coordinates; inf: (npts,)
    bool; sd: (nwin, n) int32 signed digits in sorted order, grouped by
    |digit| in 0..nbuckets along each row; idx: (nwin, n) int32 index of
    the point at each sorted position; m: block length (n % m == 0).

    Returns (buckets, S): buckets is a projective point of batch shape
    (nwin, nbuckets + 1), S the block trailers of shape (nwin, n // m)."""
    _check(ops, x, y, inf, sd, idx, m, nbuckets)
    dev = sd.device
    if dev.type == "cpu":
        return bucket_scan_plain(ops, x, y, inf, sd, idx, m, nbuckets)
    if dev.type != "cuda":
        raise ValueError(f"bucket_scan: no kernel for device {dev}")
    tensors = (x, y, inf, sd, idx)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bucket_scan: inputs must be contiguous")
    f = ops.f
    nwin, n = sd.shape
    nblk = n // m
    buckets = tuple(t.contiguous() for t in ops.infinity((nwin, nbuckets + 1)))
    S = tuple(torch.empty((f.W, nwin, nblk), dtype=torch.int32, device=dev)
              for _ in range(3))
    if nwin * nblk == 0:
        return buckets, S
    fn = build.load("block_scan", "zk_bucket_scan", _ARGTYPES)
    rc = fn(
        *(t.data_ptr() for t in tensors + buckets + S + (f.p32,)),
        f.n0, f.one_limbs.data_ptr(), ops.b3, f.W, nwin, n, x.shape[1], m,
        nbuckets + 1, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bucket_scan kernel launch failed: cudaError {rc}")
    bucket_scan.launches += 1
    return buckets, S


bucket_scan.launches = 0
