"""The general input generator: seeds per operation, uniform residues drawn
on the device, limb conversions, and the frozen setup.

Every input of a run is a function of (--seed, stream, index), so the
program and the reference see the same values, and a value can be drawn
again after the window instead of being kept.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Sequence

import numpy as np

from . import bls

M32 = (1 << 32) - 1


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for torch or numpy from the run's seed and a path."""
    ss = np.random.SeedSequence([seed % (1 << 64), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *path))


def torch_gen(seed: int, device, *path: int):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *path))
    return g


def nwords(p: int) -> int:
    return -(-p.bit_length() // 32)


def uniform_limbs(gen, mod: int, n: int, device):
    """(W, n) int32 limb planes (uint32 bit patterns, least significant
    limb first) of values uniform in [0, mod): limbs drawn from `gen` on
    the device, the top limb cut to mod's bit length, the values at or
    above mod drawn again."""
    import torch

    W = nwords(mod)
    top_bits = mod.bit_length() - 32 * (W - 1)
    mlimbs = torch.tensor([(mod >> (32 * j)) & M32 for j in range(W)],
                          dtype=torch.int64, device=device)
    out = torch.empty((W, n), dtype=torch.int64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        x = torch.randint(0, 1 << 32, (W, todo.numel()), generator=gen,
                          dtype=torch.int64, device=device)
        x[W - 1] &= (1 << top_bits) - 1
        lt = torch.zeros(todo.numel(), dtype=torch.bool, device=device)
        eq = torch.ones_like(lt)
        for j in range(W - 1, -1, -1):
            lt |= eq & (x[j] < mlimbs[j])
            eq &= x[j] == mlimbs[j]
        out[:, todo[lt]] = x[:, lt]
        todo = todo[~lt]
    return (out - ((out >> 31) << 32)).to(torch.int32)


def limbs_to_ints(limbs) -> List[int]:
    """(W, n) int32 limb planes (tensor or array) -> n Python ints."""
    arr = limbs.detach().cpu().numpy() if hasattr(limbs, "detach") else limbs
    arr = np.asarray(arr)
    W = arr.shape[0]
    flat = np.ascontiguousarray(arr.reshape(W, -1).T).astype("<u4")
    data = flat.tobytes()
    step = 4 * W
    return [int.from_bytes(data[i:i + step], "little")
            for i in range(0, len(data), step)]


def ints_to_limbs(values: Sequence[int], W: int) -> np.ndarray:
    """n Python ints -> (W, n) int32 limb planes."""
    buf = b"".join(int(v).to_bytes(4 * W, "little") for v in values)
    words = np.frombuffer(buf, dtype="<u4").reshape(len(values), W)
    return np.ascontiguousarray(words.T).view(np.int32)


def mont_ints(limbs, p: int) -> List[int]:
    """Montgomery limb planes (W, n) of GF(p), R = 2^(32 W) -> n ints."""
    arr = limbs.detach().cpu().numpy() if hasattr(limbs, "detach") else limbs
    arr = np.asarray(arr)
    r_inv = pow(1 << (32 * arr.shape[0]), -1, p)
    return [v * r_inv % p for v in limbs_to_ints(arr.reshape(arr.shape[0], -1))]


def column_sums(limbs, period: int) -> List[int]:
    """sum_k v[i + period k] for i < period, as Python ints, of the n
    values held in (W, n) limb planes (n a multiple of period)."""
    arr = limbs.detach().cpu().numpy() if hasattr(limbs, "detach") else limbs
    arr = np.asarray(arr).view(np.uint32).astype(np.uint64)
    W, n = arr.shape
    s = arr.reshape(W, n // period, period).sum(axis=1)   # < 2^32 n / period
    return [sum(int(s[j, i]) << (32 * j) for j in range(W))
            for i in range(period)]


# -- the frozen setup --------------------------------------------------------------

def load_srs(root: Path, cfg: dict) -> dict:
    """The setup of the configuration's known tau: [tau^i] G1 and
    [L_i(tau)] G1 for i < n as affine int pairs, [tau] G2, read from the
    frozen file when it is of this tau and n, else worked out on the
    host (small n only: tests)."""
    tau = int(cfg["tau"], 16)
    n = cfg["srs_points"]
    path = root / cfg["srs_file"] if cfg.get("srs_file") else None
    if path is not None and path.exists():
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta["tau"] == cfg["tau"] and meta["n"] == n:
                xs = {k: limbs_to_ints(z[k]) for k in
                      ("tau_x", "tau_y", "lag_x", "lag_y")}
                g2 = [limbs_to_ints(z[k]) for k in ("g2_x", "g2_y")]
                return dict(
                    tau=tau, n=n,
                    tau_g1=list(zip(xs["tau_x"], xs["tau_y"])),
                    lagrange_g1=list(zip(xs["lag_x"], xs["lag_y"])),
                    tau_g2=((g2[0][0], g2[0][1]), (g2[1][0], g2[1][1])))
    if n > 256:
        raise FileNotFoundError(f"no frozen setup of {n} points at {path}")
    return make_srs(tau, n)


def make_srs(tau: int, n: int) -> dict:
    fb = bls.FixedBase()
    return dict(tau=tau, n=n, tau_g1=fb.mul_many(bls.powers(tau, n)),
                lagrange_g1=fb.mul_many(bls.lagrange_at(tau, n)),
                tau_g2=bls.g2_mul(tau, bls.G2_GEN))


def save_srs(path: Path, srs: dict, tau_hex: str) -> None:
    W = nwords(bls.P)
    arrs = {
        "tau_x": ints_to_limbs([p[0] for p in srs["tau_g1"]], W),
        "tau_y": ints_to_limbs([p[1] for p in srs["tau_g1"]], W),
        "lag_x": ints_to_limbs([p[0] for p in srs["lagrange_g1"]], W),
        "lag_y": ints_to_limbs([p[1] for p in srs["lagrange_g1"]], W),
        "g2_x": ints_to_limbs(list(srs["tau_g2"][0]), W),
        "g2_y": ints_to_limbs(list(srs["tau_g2"][1]), W),
        "meta": np.frombuffer(json.dumps(
            {"tau": tau_hex, "n": srs["n"]}).encode(), dtype=np.uint8),
    }
    np.savez(path, **arrs)
