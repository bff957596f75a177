"""Kernel K5: one radix-2 NTT butterfly stage, and its plain version.

`ntt_stage(x, tw, s, f)` runs stage s of a decimation-in-time NTT in
place on x, a contiguous (W, B, S, lanes) int32 limb tensor of field `f`
in Montgomery form, S and lanes powers of two.  With half = 2^(s-1), the
rows of the S axis form S / (2 half) blocks of 2 half rows; in each block
row j (j < half) holds u and row j + half holds v, and they become
u + v tw[j] and u - v tw[j], canonical mod p.  tw is the stage's (W, half)
twiddle table.  All B batches and all `lanes` columns run the same
butterflies.

On a CUDA tensor the wrapper launches the hand-written kernel of
`csrc/ntt_stage.cu` (one thread per pair, W = 8 only); on a CPU tensor it
runs `ntt_stage_plain`.  There is no other path: another device, another
W on the card, a failed build or a refused launch raises.

It replaces the Pallas kernel `_build_butterfly` / `butterfly_pallas` of
zikkurat_algebra_tpu/ops/pallas_field.py, which computes the same
butterfly on operands gathered and broadcast to n/2 outside the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import limbs as lb
from .kernel_field import mont_mul_plain
from ..utils import build


def _log2(v: int, what: str) -> int:
    if v < 1 or v & (v - 1):
        raise ValueError(f"ntt_stage: {what} = {v} is not a power of two")
    return v.bit_length() - 1


def _check(x: torch.Tensor, tw: torch.Tensor, s: int, f):
    if x.dtype != torch.int32 or tw.dtype != torch.int32:
        raise TypeError("ntt_stage takes int32 limb planes")
    if x.ndim != 4 or x.shape[0] != f.W:
        raise ValueError(f"ntt_stage: x {tuple(x.shape)}; want (W={f.W}, B, "
                         "S, lanes)")
    log_rows = _log2(x.shape[2], "S")
    log_lanes = _log2(x.shape[3], "lanes")
    if not 1 <= s <= log_rows:
        raise ValueError(f"ntt_stage: stage {s} not in [1, log2 S = "
                         f"{log_rows}]")
    if tuple(tw.shape) != (f.W, 1 << (s - 1)):
        raise ValueError(f"ntt_stage: table {tuple(tw.shape)} for stage {s}; "
                         f"want ({f.W}, {1 << (s - 1)})")
    if x.device != tw.device or x.device != f.device:
        raise ValueError(f"ntt_stage: devices {x.device}, {tw.device} for a "
                         f"field on {f.device}")
    if not (x.is_contiguous() and tw.is_contiguous()):
        raise ValueError("ntt_stage: x and the table must be contiguous")
    return log_rows, log_lanes


def ntt_stage_plain(x: torch.Tensor, tw: torch.Tensor, s: int, f
                    ) -> torch.Tensor:
    """Plain torch version, in place on any device: the reshape, product
    and add/sub of the JAX `_transform` stage, over `mont_mul_plain`."""
    _check(x, tw, s, f)
    W, B, S, lanes = x.shape
    half = 1 << (s - 1)
    xb = x.view(W, B, S // (2 * half), 2, half, lanes)
    u, v = xb[:, :, :, 0], xb[:, :, :, 1]
    t = mont_mul_plain(v.contiguous(), tw.view(W, 1, 1, half, 1).expand(
        v.shape).contiguous(), f)
    hi = lb.add_mod(u, t, f.p64)
    lo = lb.sub_mod(u, t, f.p64)
    xb[:, :, :, 0] = hi
    xb[:, :, :, 1] = lo
    return x


_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_uint32, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
KERNEL_W = (8,)             # the widths csrc/ntt_stage.cu is built for


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, s: int, f) -> torch.Tensor:
    """Stage s of the radix-2 DIT NTT on x (W, B, S, lanes), in place;
    returns x.  CUDA tensors launch kernel K5; CPU tensors run the plain
    version."""
    log_rows, log_lanes = _check(x, tw, s, f)
    if x.device.type == "cpu":
        return ntt_stage_plain(x, tw, s, f)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_stage: no kernel for device {x.device}")
    if f.W not in KERNEL_W:
        raise ValueError(f"ntt_stage: the kernel is built for W in "
                         f"{KERNEL_W}, not {f.W}")
    if x.shape[1] == 0:
        return x
    fn = build.load("ntt_stage", "zk_ntt_stage", _ARGTYPES)
    rc = fn(x.data_ptr(), tw.data_ptr(), f.p32.data_ptr(), f.n0, f.W,
            x.shape[1], log_rows, log_lanes, s,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ntt_stage kernel launch failed: cudaError {rc}")
    ntt_stage.launches += 1
    return x


ntt_stage.launches = 0
