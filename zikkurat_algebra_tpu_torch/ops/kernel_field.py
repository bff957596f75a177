"""Kernels K1 and P2: the elementwise Montgomery product and a field
exponentiation in one launch, and their plain versions.

`mont_mul(a, b, f)` computes a * b * R^-1 mod p on (W, *batch) limb
planes and gives canonical output limbs; b must be canonical, a any value
below R (so a product by R mod p reduces a).  On a CUDA tensor it
launches the hand-written kernel of `csrc/mont_mul.cu` (CIOS over 32-bit
limbs, one element per thread, W in `KERNEL_WIDTHS`); on a CPU tensor it
runs `mont_mul_plain`.  There is no other path: a tensor on any other
device, a width the kernel does not take, a failed build or a refused
launch raises.

It replaces the Pallas kernel `_build_mont_mul` / `mont_mul_pallas` of
zikkurat_algebra_tpu/ops/pallas_field.py, which works on signed
radix-2^15 limbs because the TPU has no 32x32->64 multiply.

`mont_mul_plain` is an independent algorithm on purpose: the product is
a convolution of 16-bit digits (each column sum fits int64), followed by
one bulk Montgomery reduction m = (T mod R) * (-p^-1) mod R,
U = (T + m p) / R and one conditional subtraction.  A canonical result is
unique, so it equals the kernel's limb for limb.

`field_pow(a, e, f)` computes a^e for an exponent e, a host int.  On a
CUDA tensor it launches `csrc/field_pow.cu` (kernel P2: the whole
square-and-multiply chain in registers, one launch per `POW_WORDS` words
of exponent), with the same checks as `mont_mul`; on a CPU tensor it runs `field_pow_plain`, the square-and-multiply loop over
`mont_mul_plain`, which the kernel equals limb for limb.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Tuple

import torch

from . import limbs as lb
from ..utils import build

I64 = torch.int64
M16 = 0xFFFF


# -- plain version -------------------------------------------------------------

def _split16(a: torch.Tensor) -> torch.Tensor:
    """(W, *batch) int32 limbs -> (2W, N) int64 16-bit digits."""
    x = lb.to64(a)
    return torch.stack([x & M16, x >> 16], 1).reshape(2 * a.shape[0], -1)


@lru_cache(maxsize=None)
def _conv_index(D: int, device: str) -> torch.Tensor:
    i = torch.arange(D, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


def _conv(A: torch.Tensor, B: torch.Tensor, ncols: int) -> torch.Tensor:
    """Column sums of the digit product: out[k] = sum_{i+j=k} A[i] B[j];
    A (D, N), B (D, N) or (D, 1); columns beyond ncols are dropped."""
    D = A.shape[0]
    prod = (A.unsqueeze(1) * B.unsqueeze(0)).reshape(D * D, -1)
    out = torch.zeros(2 * D - 1, prod.shape[1], dtype=I64, device=A.device)
    out.index_add_(0, _conv_index(D, str(A.device)), prod)
    if ncols <= 2 * D - 1:
        return out[:ncols]
    pad = torch.zeros(ncols - (2 * D - 1), out.shape[1], dtype=I64,
                      device=A.device)
    return torch.cat([out, pad], 0)


def _partial16(T: torch.Tensor) -> torch.Tensor:
    """Nonnegative int64 columns < 2^40 of radix 2^16 -> columns below
    2^16 + 2 of the same value mod 2^(16 * ncols), by two passes that move
    each column's high part up one."""
    for _ in range(2):
        hi = T >> 16
        T = (T & M16) + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]], 0)
    return T


def _norm16(T: torch.Tensor) -> torch.Tensor:
    """Nonnegative int64 columns < 2^40, at most 60 of them -> 16-bit
    digits of the same value mod 2^(16 * ncols): after `_partial16` every
    carry is 0 or 1, and the carry-ins are resolved at once."""
    T = _partial16(T)
    r = T & M16
    cin, _ = lb.carry_ins(T >> 16, r == M16)
    return (r + cin) & M16


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, f) -> torch.Tensor:
    """Plain torch Montgomery product of (W, *batch) canonical limb
    planes, on any device."""
    W = f.W
    D = 2 * W
    shape = a.shape
    T = _norm16(_conv(_split16(a), _split16(b), 2 * D + 1))
    m = _norm16(_conv(T[:D], f.np16.view(D, 1), D))
    U = _norm16(T + _conv(m, f.p16.view(D, 1), 2 * D + 1))
    hi = U[D:2 * D].view(W, 2, -1)
    res = torch.cat([hi[:, 0] | (hi[:, 1] << 16), U[2 * D:]], 0)
    return lb.to32(lb.cond_sub(res, f.p64_ext)[:W]).reshape(shape)


# -- kernel --------------------------------------------------------------------

KERNEL_WIDTHS = (1, 2, 3, 4, 8, 12)     # the instantiations of zk_mont_mul
_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_uint32, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
]


def mont_mul(a: torch.Tensor, b: torch.Tensor, f) -> torch.Tensor:
    """a * b * R^-1 mod p on canonical (W, *batch) int32 limb planes of
    field `f`.  CUDA tensors launch kernel K1; CPU tensors run the plain
    version."""
    if a.shape != b.shape or a.shape[0] != f.W:
        raise ValueError(f"mont_mul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} for W={f.W}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul takes int32 limb planes")
    if a.device != b.device or a.device != f.device:
        raise ValueError(f"mont_mul: devices {a.device}, {b.device} for a "
                         f"field on {f.device}")
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, f)
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul: no kernel for device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mont_mul: limb planes must be contiguous")
    if f.W not in KERNEL_WIDTHS:
        raise ValueError(f"mont_mul: no kernel for W={f.W} (widths "
                         f"{KERNEL_WIDTHS})")
    out = torch.empty_like(a)
    n = a.numel() // f.W
    if n == 0:
        return out
    fn = build.load("mont_mul", "zk_mont_mul", _ARGTYPES)
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), f.p32.data_ptr(),
            f.n0, f.W, n, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: cudaError {rc}")
    mont_mul.launches += 1
    return out


mont_mul.launches = 0


# -- exponentiation ------------------------------------------------------------

POW_WORDS = 16          # exponent words per P2 launch (kPowWords in the .cu)
_POW_ARGTYPES = [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_uint32, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p,
]


def field_pow_plain(a: torch.Tensor, e: int, f, mul=mont_mul_plain
                    ) -> torch.Tensor:
    """a^e on (W, *batch) limb planes for a host int e >= 0: MSB-first
    square-and-multiply, one `mul` (by default `mont_mul_plain`, on any
    device) per squaring and product; a^0 = 1, and a^1 is a itself."""
    if e == 0:
        return f.one(a.shape[1:]).contiguous()
    acc = a
    for i in range(e.bit_length() - 2, -1, -1):
        acc = mul(acc, acc, f)
        if e >> i & 1:
            acc = mul(acc, a, f)
    return acc


@lru_cache(maxsize=None)
def _pow_consts(p: int, W: int) -> tuple:
    """(p, R mod p) as host words, R = 2^(32 W)."""
    return lb.host_words(p, W), lb.host_words((1 << 32 * W) % p, W)


def _pow_chunks(e: int) -> List[Tuple[int, ctypes.Array]]:
    """The exponent e >= 0 as P2's launches, top chunk first: (bit count,
    host words).  Chunks of 32 POW_WORDS bits from the least significant
    bit up; the top chunk holds the rest, ending at the top set bit (0
    bits for e = 0)."""
    size = 32 * POW_WORDS
    nchunks = max(1, -(-e.bit_length() // size))
    out = []
    for j in range(nchunks - 1, -1, -1):
        chunk = (e >> (j * size)) & ((1 << size) - 1)
        nbits = chunk.bit_length() if j == nchunks - 1 else size
        out.append((nbits, lb.host_words(chunk, POW_WORDS)))
    return out


def field_pow(a: torch.Tensor, e: int, f) -> torch.Tensor:
    """a^e on (W, *batch) int32 limb planes of field `f` for a host int
    e >= 0.  CUDA tensors launch kernel P2 once
    per `POW_WORDS` words of e; CPU tensors run `field_pow_plain`."""
    if a.ndim < 1 or a.shape[0] != f.W:
        raise ValueError(f"field_pow: shape {tuple(a.shape)} for W={f.W}")
    if a.dtype != torch.int32:
        raise TypeError("field_pow takes int32 limb planes")
    if a.device != f.device:
        raise ValueError(f"field_pow: device {a.device} for a field on "
                         f"{f.device}")
    if a.device.type == "cpu":
        return field_pow_plain(a, e, f)
    if a.device.type != "cuda":
        raise ValueError(f"field_pow: no kernel for device {a.device}")
    if not a.is_contiguous():
        raise ValueError("field_pow: limb planes must be contiguous")
    if f.W not in KERNEL_WIDTHS:
        raise ValueError(f"field_pow: no kernel for W={f.W} (widths "
                         f"{KERNEL_WIDTHS})")
    n = a.numel() // f.W
    if n == 0:
        return torch.empty_like(a)
    fn = build.load("field_pow", "zk_field_pow", _POW_ARGTYPES)
    p, one = _pow_consts(f.p, f.W)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    acc = None
    for nbits, words in _pow_chunks(e):
        out = torch.empty_like(a)
        rc = fn(a.data_ptr(), None if acc is None else acc.data_ptr(),
                out.data_ptr(), p, one, words, nbits, f.n0, f.W, n, stream)
        if rc != 0:
            raise RuntimeError(f"field_pow kernel launch failed: cudaError "
                               f"{rc}")
        field_pow.launches += 1
        acc = out
    return acc


field_pow.launches = 0
