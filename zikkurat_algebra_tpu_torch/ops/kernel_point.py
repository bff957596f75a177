"""A G1 point operation in one launch: complete projective addition and
doubling on CUDA tensors (`csrc/point_ops.cu`).

`point_add(ops, P, Q)` and `point_dbl(ops, P)` take points of the group
law `ops` (an `ops.curve.ProjCurveOps` over Fp, coordinates (W, *batch)
Montgomery limb planes) and return (X, Y, Z) of the broadcast batch
shape, equal limb for limb to the torch law of `ProjCurveOps.add` and
`.dbl` (RCB15 algorithms 7 and 9, a = 0, the same operation order).
The operands are broadcast against each other and made contiguous over
the batch; the kernel reads each coordinate once and writes the three
output planes, one thread per point.

`ProjCurveOps.add` / `.dbl` call these where `ProjCurveOps._fused`
holds: G1 coordinates on a CUDA tensor, W in `WIDTHS`, over the kernel
field.  Their plain version is the torch law itself, which runs for
every other input (G2, CPU tensors, `ProjCurveOps.plain()`), so these
wrappers take CUDA tensors only and raise on any other device.  Each
counts its launches (`point_add.launches`, `point_dbl.launches`).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from ..utils import build
from . import limbs as lb

WIDTHS = (8, 12)            # the instantiations of zk_point_add / _dbl
_TAIL = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_void_p]
_ARGTYPES_ADD = [ctypes.c_void_p] * 9 + _TAIL
_ARGTYPES_DBL = [ctypes.c_void_p] * 6 + _TAIL


@lru_cache(maxsize=None)
def _consts(p: int, b3: int, W: int) -> tuple:
    """(p, b3 R mod p) as host words, R = 2^(32 W)."""
    return lb.host_words(p, W), lb.host_words(b3 % p * (1 << 32 * W) % p, W)


def _operands(name: str, ops, coords) -> Tuple[torch.Tensor, ...]:
    """The coordinates checked, broadcast to one shape and contiguous."""
    f = ops.f
    if f.struct_ndim != 1 or f.W not in WIDTHS:
        raise ValueError(f"{name}: no kernel for {f!r} (G1 over Fp, W in "
                         f"{WIDTHS})")
    for t in coords:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: coordinates are int32 limb planes")
        if t.ndim < 1 or t.shape[0] != f.W:
            raise ValueError(f"{name}: coordinate {tuple(t.shape)}, want "
                             f"({f.W}, *batch)")
        if t.device != f.device:
            raise ValueError(f"{name}: coordinate on {t.device} for a field "
                             f"on {f.device}")
    if f.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {f.device} (the "
                         "torch law of ProjCurveOps runs there)")
    return tuple(t.contiguous() for t in torch.broadcast_tensors(*coords))


def _launch(name: str, symbol: str, argtypes, ops, coords):
    f = ops.f
    ts = _operands(name, ops, coords)
    out = torch.empty((3,) + ts[0].shape, dtype=torch.int32,
                      device=f.device)
    res = tuple(out.unbind(0))
    n = ts[0].numel() // f.W
    if n == 0:
        return res, False
    fn = build.load("point_ops", symbol, argtypes)
    rc = fn(*(t.data_ptr() for t in ts + res), *_consts(f.p, ops.b3, f.W),
            f.n0, f.W, n, torch.cuda.current_stream(f.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return res, True


def point_add(ops, P, Q):
    """P + Q for G1 points of `ops` on the card: one launch."""
    res, launched = _launch("point_add", "zk_point_add", _ARGTYPES_ADD, ops,
                            tuple(P) + tuple(Q))
    point_add.launches += launched
    return res


def point_dbl(ops, P):
    """2 P for G1 points of `ops` on the card: one launch."""
    res, launched = _launch("point_dbl", "zk_point_dbl", _ARGTYPES_DBL, ops,
                            tuple(P))
    point_dbl.launches += launched
    return res


point_add.launches = 0
point_dbl.launches = 0
