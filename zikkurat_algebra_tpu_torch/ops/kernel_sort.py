"""Kernel K3: the MSM's grouping sort, and its plain version.

`sort_key_val(keys, payload, key_bits)` sorts each row of non-negative
int32 keys (wc, n), all below 2^key_bits, in ascending order and carries
the R int32 payload rows (R, wc, n) along.  The sort is stable: equal keys
keep their input order.  On a CUDA tensor the wrapper launches the
hand-written Onesweep radix sort of `csrc/sort.cu`; on a CPU tensor it runs
`sort_key_val_plain` (`torch.sort(stable=True)` and a gather), which is
also what the kernel is held to, exactly, on the card.

It replaces the Pallas kernel `_build_local` / `sort_key_val_pallas` of
zikkurat_algebra_tpu/ops/pallas_sort.py, a bitonic network that is not
stable and needs n to be a power of two.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build


def _check(keys, payload, key_bits: int):
    if keys.dtype != torch.int32 or payload.dtype != torch.int32:
        raise TypeError("sort_key_val: keys and payload are int32")
    if keys.ndim != 2 or payload.ndim != 3 or payload.shape[1:] != keys.shape:
        raise ValueError(f"sort_key_val: keys {tuple(keys.shape)}, payload "
                         f"{tuple(payload.shape)}; want (wc, n), (R, wc, n)")
    if not 1 <= key_bits <= 31:
        raise ValueError(f"sort_key_val: key_bits {key_bits} not in [1, 31]")
    if keys.device != payload.device:
        raise ValueError(f"sort_key_val: keys on {keys.device}, payload on "
                         f"{payload.device}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sort_key_val: no kernel for device {keys.device}")
    if keys.numel():
        lo, hi = (int(v) for v in torch.aminmax(keys))
        if lo < 0 or hi >= 1 << key_bits:
            raise ValueError(f"sort_key_val: keys span [{lo}, {hi}], outside "
                             f"[0, 2^{key_bits})")


def sort_key_val_plain(keys: torch.Tensor, payload: torch.Tensor):
    """Plain torch version: a stable sort of each row and a gather of the
    payload by the permutation."""
    sk, order = torch.sort(keys, dim=1, stable=True)
    sp = torch.gather(payload, 2, order.unsqueeze(0).expand(payload.shape))
    return sk, sp


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SCRATCH_ARGTYPES = [ctypes.c_int] * 3
_OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]


def sort_key_val(keys: torch.Tensor, payload: torch.Tensor, key_bits: int):
    """Stable ascending sort of each row of `keys` (wc, n), carrying
    `payload` (R, wc, n).  Returns (sorted keys, sorted payload).  Keys
    outside [0, 2^key_bits) raise."""
    _check(keys, payload, key_bits)
    dev = keys.device
    if dev.type == "cpu":
        return sort_key_val_plain(keys, payload)
    if not (keys.is_contiguous() and payload.is_contiguous()):
        raise ValueError("sort_key_val: keys and payload must be contiguous")
    wc, n = keys.shape
    R = payload.shape[0]
    kout, pout = torch.empty_like(keys), torch.empty_like(payload)
    if wc * n == 0:
        return kout, pout
    kt, pt = torch.empty_like(keys), torch.empty_like(payload)
    nbytes = build.load("sort", "zk_sort_scratch_bytes", _SCRATCH_ARGTYPES,
                        ctypes.c_longlong)(wc, n, key_bits)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = build.load("sort", "zk_sort_key_val", _ARGTYPES)
    rc = fn(keys.data_ptr(), payload.data_ptr(), kout.data_ptr(),
            pout.data_ptr(), kt.data_ptr(), pt.data_ptr(), scratch.data_ptr(),
            wc, n, R, key_bits, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sort_key_val kernel launch failed: cudaError {rc}")
    sort_key_val.launches += 1
    return kout, pout


sort_key_val.launches = 0


def occupancy(wc: int, n: int):
    """(resident CTAs per SM, CTAs per pass) of the kernel's pass launch
    for keys (wc, n), on the current card."""
    per_sm, ctas = ctypes.c_int(), ctypes.c_longlong()
    rc = build.load("sort", "zk_sort_occupancy", _OCCUPANCY_ARGTYPES)(
        wc, n, ctypes.addressof(per_sm), ctypes.addressof(ctas))
    if rc != 0:
        raise RuntimeError(f"sort occupancy query failed: cudaError {rc}")
    return per_sm.value, ctas.value
