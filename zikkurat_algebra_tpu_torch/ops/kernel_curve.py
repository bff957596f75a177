"""Kernels K2 (G1) and K4 (G2): level-1 bucket accumulation of the MSM, and
their plain version.

`bucket_scan` keeps, for each (window, block) of the sorted digit rows,
the running projective sum over the m positions of the block:

    acc = restart ? from_affine(pt) : madd(acc, pt)

where pt is the point of that position (gathered by its index, y negated
for a negative digit, the identity if the point is at infinity), madd is
RCB15 algorithm 8, and the sum restarts at the block's first position and
wherever the digit changes.  It writes only what the MSM reads afterwards:

* the running value at each segment's global tail (the last position of
  a digit in the whole row) into bucket[w, digit] -- each (window, digit)
  has exactly one global tail, so no two lanes write the same slot;
* the running value at each block's last position, the trailer S[w, blk]
  that the level-2 carries combine across blocks.

Buckets that no tail writes stay at infinity.  The plain version walks
the positions in order, one lane per block.  K2 splits each block among
eight sub-lanes and K4 among four, and both join the sub-lanes' sums
with complete additions, so their buckets and trailers are the same
points as the plain version's in other projective coordinates: they are
compared after `to_affine`.

`bucket_scan` dispatches on the coordinates' rank: Fp coordinates
(W, npts) go to K2, Fp2 coordinates (W, 2, npts) to K4 (`bucket_scan2`).
On a CUDA tensor each wrapper launches its hand-written kernel,
`csrc/block_scan.cu` or `csrc/block_scan2.cu`; on a CPU tensor both run
`bucket_scan_plain`, which works over either coordinate field.

They replace the Pallas kernels `_build_block_scan` / `block_madd_scan`
and `_build_block_scan2` / `block_madd_scan2` of
zikkurat_algebra_tpu/ops/pallas_curve.py, which stream a packed sort
payload and write every running value, because the TPU has no gather.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from .curve import ProjCurveOps


def _check(ops: ProjCurveOps, x, y, inf, sd, idx, m: int, nbuckets: int):
    elem = x.shape[:ops.f.struct_ndim]
    want = (ops.f.W,) + (2,) * (ops.f.struct_ndim - 1)
    if x.dtype != torch.int32 or y.dtype != torch.int32:
        raise TypeError("bucket_scan: x and y are int32 limb planes")
    if x.ndim != len(want) + 1 or elem != want or y.shape != x.shape:
        raise ValueError(f"bucket_scan: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, want {want + ('npts',)}")
    if inf.dtype != torch.bool or inf.shape != (x.shape[-1],):
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
    """Plain torch version, over Fp or Fp2 coordinates: a loop over the m
    block positions, each a batched madd over all (window, block) lanes."""
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
        py = y[..., i]
        pt = (x[..., i], f.select(neg[..., j], f.neg(py), py), inf[i])
        restart = (torch.ones_like(neg[..., 0]) if j == 0
                   else a[..., j] != a[..., j - 1])
        acc = ops.select(restart, ops.from_affine(pt), ops.madd(acc, pt))
        t = tail[..., j]
        wi, ai = rows[t], a[..., j][t]
        for b, v in zip(buckets, acc):
            b[..., wi, ai] = v[..., t]
    return buckets, acc


_ARGTYPES = [ctypes.c_void_p] * 12 + [
    ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def _host_words(v: int, W: int):
    """v as W 32-bit words in host memory, least significant first (K2
    and K4 take their field constants as kernel parameters)."""
    return (ctypes.c_uint32 * W)(*((v >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(W)))


def _outputs(ops: ProjCurveOps, sd, m: int, nbuckets: int):
    """Buckets at infinity and uninitialised trailers on sd's device."""
    nwin, n = sd.shape
    buckets = tuple(t.contiguous() for t in ops.infinity((nwin, nbuckets + 1)))
    S = tuple(torch.empty(buckets[0].shape[:-1] + (n // m,), dtype=torch.int32,
                          device=sd.device) for _ in range(3))
    return buckets, S


def bucket_scan(ops: ProjCurveOps, x, y, inf, sd, idx, m: int,
                nbuckets: int):
    """Level-1 bucket accumulation.

    x, y: (W, npts) Fp or (W, 2, npts) Fp2 canonical Montgomery affine
    coordinates; inf: (npts,) bool; sd: (nwin, n) int32 signed digits in
    sorted order, grouped by |digit| in 0..nbuckets along each row; idx:
    (nwin, n) int32 index of the point at each sorted position; m: block
    length (n % m == 0).

    Returns (buckets, S): buckets is a projective point of batch shape
    (nwin, nbuckets + 1), S the block trailers of shape (nwin, n // m).
    Fp2 coordinates go to `bucket_scan2` (kernel K4)."""
    if x.ndim == 3:
        return bucket_scan2(ops, x, y, inf, sd, idx, m, nbuckets)
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
    buckets, S = _outputs(ops, sd, m, nbuckets)
    if nwin * n == 0:
        return buckets, S
    fn = build.load("block_scan", "zk_bucket_scan", _ARGTYPES)
    rc = fn(
        *(t.data_ptr() for t in tensors + buckets + S),
        _host_words(f.p, f.W), f.n0, _host_words(f.R % f.p, f.W), ops.b3,
        f.W, nwin, n, x.shape[1], m, nbuckets + 1,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bucket_scan kernel launch failed: cudaError {rc}")
    bucket_scan.launches += 1
    return buckets, S


bucket_scan.launches = 0


def _occupancy(src: str, symbol: str, W: int, nwin: int, n: int, m: int):
    per_sm, ctas = ctypes.c_int(), ctypes.c_longlong()
    fn = build.load(src, symbol, [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    rc = fn(W, nwin, n, m, ctypes.addressof(per_sm), ctypes.addressof(ctas))
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: cudaError {rc}")
    return per_sm.value, ctas.value


def bucket_scan_occupancy(W: int, nwin: int, n: int, m: int):
    """(resident CTAs per SM, CTAs launched) of K2 at W limbs for nwin
    windows of n positions at block m, on the current card."""
    return _occupancy("block_scan", "zk_bucket_scan_occupancy", W, nwin, n, m)


def bucket_scan2_occupancy(W: int, nwin: int, n: int, m: int):
    """The same for K4 (W limbs per Fp2 component)."""
    return _occupancy("block_scan2", "zk_bucket_scan2_occupancy", W, nwin, n,
                      m)


_ARGTYPES2 = [ctypes.c_void_p] * 12 + [
    ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def _fp2_consts(fp, b3, qnr: int):
    """K4's constants as host words: p, n0, the Montgomery one, b3 (c0
    then c1, Montgomery form) and qnr."""
    W = fp.W
    b3m = [c * fp.R % fp.p for c in b3]
    return (_host_words(fp.p, W), fp.n0, _host_words(fp.R % fp.p, W),
            _host_words(b3m[0] | b3m[1] << (32 * W), 2 * W), qnr)


def bucket_scan2(ops: ProjCurveOps, x, y, inf, sd, idx, m: int,
                 nbuckets: int):
    """`bucket_scan` over Fp2 coordinates x, y (W, 2, npts): kernel K4 on a
    CUDA tensor, the plain version on a CPU tensor.  Buckets and trailers
    are (W, 2, nwin, .) planes."""
    _check(ops, x, y, inf, sd, idx, m, nbuckets)
    if x.ndim != 3:
        raise ValueError("bucket_scan2: x and y are (W, 2, npts) Fp2 planes")
    dev = sd.device
    if dev.type == "cpu":
        return bucket_scan_plain(ops, x, y, inf, sd, idx, m, nbuckets)
    if dev.type != "cuda":
        raise ValueError(f"bucket_scan2: no kernel for device {dev}")
    tensors = (x, y, inf, sd, idx)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bucket_scan2: inputs must be contiguous")
    f = ops.f
    fp = f.base
    nwin, n = sd.shape
    buckets, S = _outputs(ops, sd, m, nbuckets)
    if nwin * n == 0:
        return buckets, S
    fn = build.load("block_scan2", "zk_bucket_scan2", _ARGTYPES2)
    rc = fn(
        *(t.data_ptr() for t in tensors + buckets + S),
        *_fp2_consts(fp, ops.b3, f.qnr), f.W, nwin, n, x.shape[-1], m,
        nbuckets + 1, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bucket_scan2 kernel launch failed: cudaError {rc}")
    bucket_scan2.launches += 1
    return buckets, S


bucket_scan2.launches = 0
