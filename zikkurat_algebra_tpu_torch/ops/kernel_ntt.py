"""Kernel K5: radix-2 NTT stages in shared memory, and its plain version.

`ntt_stages(x, tables, s0, k, f)` runs stages s0+1 .. s0+k of a
decimation-in-time NTT in place on x, a contiguous (W, B, S, lanes) int32
limb tensor of field `f` in Montgomery form, S and lanes powers of two.
Stage s, with half = 2^(s-1), splits the rows of the S axis into blocks
of 2 half rows; in each block row j (j < half) holds u and row j + half
holds v, and they become u + v tw[j] and u - v tw[j], canonical mod p,
tw = tables[s - 1], the stage's (W, half) twiddle table.  All B batches
and all `lanes` columns run the same butterflies.

On a CUDA tensor the wrapper launches the hand-written kernel of
`csrc/ntt_stage.cu` once (W = 8 or 2): it loads tiles of the rows the k
stages combine into shared memory, runs the stages there and writes them
back.  The tile holds 2^TILE_LOG[W] elements, a launch argument of the
kernel.  `pass_plan` splits a transform's stages into such launches (a
2^20 transform: 3 at W = 8, 2 at W = 2); the counter
`ntt_stages.launches` counts launches, that is passes.  On a CPU tensor
it runs `ntt_stages_plain`, k calls of `ntt_stage_plain`.  There is no
other path: another device, another W on the card, a failed build or a
refused launch raises.

It replaces the Pallas kernel `_build_butterfly` / `butterfly_pallas` of
zikkurat_algebra_tpu/ops/pallas_field.py, which computes one stage's
butterfly on operands gathered and broadcast to n/2 outside the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import limbs as lb
from .kernel_field import mont_mul_plain
from ..utils import build


TILE_LOG = {8: 10, 2: 13}  # log2 of a tile's elements, by W: 32 KB at W = 8,
#                            64 KB at W = 2 (the kernel takes it per launch)
COLS_LOG = 5               # a strided pass moves >= 2^5 consecutive columns
KERNEL_W = (2, 8)          # the widths csrc/ntt_stage.cu is built for


def tile_log(W: int) -> int:
    """log2 of the elements a K5 tile holds at width W; for a W the
    kernel is not built for (CPU only) that of W = 8."""
    return TILE_LOG.get(W, TILE_LOG[8])


def pass_plan(log_rows: int, log_lanes: int, log_tile: int) -> list:
    """The launches of a transform of 2^log_rows rows of 2^log_lanes
    columns on tiles of 2^log_tile elements (`tile_log(W)`), as (s0, k)
    pairs: stages s0+1 .. s0+k each, in order.  A pass whose rows lie
    2^(s0 + log_lanes) apart takes as many stages as a tile holds: all of
    them while that span is below 2^COLS_LOG (the tile is contiguous),
    else log_tile - COLS_LOG, spread evenly over the passes the rest
    needs."""
    plan, s0 = [], 0
    while s0 < log_rows:
        rest = log_rows - s0
        span = s0 + log_lanes
        kmax = max(1, log_tile - min(span, COLS_LOG))
        if span < COLS_LOG:
            k = min(rest, kmax)
        else:
            k = -(-rest // -(-rest // kmax))
        plan.append((s0, k))
        s0 += k
    return plan


def _log2(v: int, what: str) -> int:
    if v < 1 or v & (v - 1):
        raise ValueError(f"ntt_stages: {what} = {v} is not a power of two")
    return v.bit_length() - 1


def _check(x: torch.Tensor, tws, s0: int, f):
    """Checks x and the tables tws of stages s0+1 .. s0+len(tws)."""
    if x.dtype != torch.int32 or any(t.dtype != torch.int32 for t in tws):
        raise TypeError("ntt_stages takes int32 limb planes")
    if x.ndim != 4 or x.shape[0] != f.W:
        raise ValueError(f"ntt_stages: x {tuple(x.shape)}; want (W={f.W}, B, "
                         "S, lanes)")
    log_rows = _log2(x.shape[2], "S")
    log_lanes = _log2(x.shape[3], "lanes")
    if not (tws and s0 >= 0 and s0 + len(tws) <= log_rows):
        raise ValueError(f"ntt_stages: stages {s0 + 1}..{s0 + len(tws)} not "
                         f"in [1, log2 S = {log_rows}]")
    for s, tw in enumerate(tws, s0 + 1):
        if tuple(tw.shape) != (f.W, 1 << (s - 1)):
            raise ValueError(f"ntt_stages: table {tuple(tw.shape)} for stage "
                             f"{s}; want ({f.W}, {1 << (s - 1)})")
        if tw.device != x.device or not tw.is_contiguous():
            raise ValueError("ntt_stages: the tables must be contiguous, on "
                             "x's device")
    if x.device != f.device:
        raise ValueError(f"ntt_stages: x on {x.device} for a field on "
                         f"{f.device}")
    if not x.is_contiguous():
        raise ValueError("ntt_stages: x must be contiguous")
    return log_rows, log_lanes


def ntt_stage_plain(x: torch.Tensor, tw: torch.Tensor, s: int, f
                    ) -> torch.Tensor:
    """Plain torch version of stage s, in place on any device: the
    reshape, product and add/sub of the JAX `_transform` stage, over
    `mont_mul_plain`."""
    _check(x, [tw], s - 1, f)
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


def ntt_stages_plain(x: torch.Tensor, tables, s0: int, k: int, f
                     ) -> torch.Tensor:
    """Plain torch version of stages s0+1 .. s0+k: k calls of
    `ntt_stage_plain`, in place; tables[s - 1] is stage s's table."""
    for s in range(s0 + 1, s0 + k + 1):
        ntt_stage_plain(x, tables[s - 1], s, f)
    return x


_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_uint32, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def ntt_stages(x: torch.Tensor, tables, s0: int, k: int, f) -> torch.Tensor:
    """Stages s0+1 .. s0+k of the radix-2 DIT NTT on x (W, B, S, lanes),
    in place; tables[s - 1] is stage s's table; returns x.  CUDA tensors
    launch kernel K5 once; CPU tensors run the plain version."""
    if k < 1 or s0 < 0 or s0 + k > len(tables):
        raise ValueError(f"ntt_stages: stages {s0 + 1}..{s0 + k} of "
                         f"{len(tables)} tables")
    tws = list(tables[s0:s0 + k])
    log_rows, log_lanes = _check(x, tws, s0, f)
    if x.device.type == "cpu":
        return ntt_stages_plain(x, tables, s0, k, f)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_stages: no kernel for device {x.device}")
    if f.W not in KERNEL_W:
        raise ValueError(f"ntt_stages: the kernel is built for W in "
                         f"{KERNEL_W}, not {f.W}")
    if k > tile_log(f.W):
        raise ValueError(f"ntt_stages: {k} stages in one launch; a tile at "
                         f"W={f.W} holds {tile_log(f.W)}")
    if x.shape[1] == 0:
        return x
    fn = build.load("ntt_stage", "zk_ntt_stages", _ARGTYPES)
    ptrs = (ctypes.c_void_p * k)(*(t.data_ptr() for t in tws))
    rc = fn(x.data_ptr(), ctypes.addressof(ptrs), f.p32.data_ptr(),
            f.one_limbs.data_ptr(), f.n0, f.W, x.shape[1], log_rows,
            log_lanes, s0, k, tile_log(f.W),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ntt_stages kernel launch failed: cudaError {rc}")
    ntt_stages.launches += 1
    return x


ntt_stages.launches = 0


def occupancy(W: int):
    """(resident CTAs per SM, shared-memory bytes) of a full K5 tile."""
    fn = build.load("ntt_stage", "zk_ntt_stages_occupancy",
                    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    per = ctypes.c_int()
    rc = fn(W, tile_log(W), ctypes.addressof(per))
    if rc != 0:
        raise RuntimeError(f"zk_ntt_stages_occupancy failed: cudaError {rc}")
    return per.value, 4 * W << tile_log(W)
