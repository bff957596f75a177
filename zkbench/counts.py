"""The yardstick: the table of peaks, the operations and bytes that kernels
K2 (G1 bucket scan) and K5 (NTT stages) need, and the reduction of a
profiler's kernel records to busy time, kernel sums and idle gaps.

Bounds: bytes (each input read once, each output written once) at the
card's HBM rate; operations as 32-bit multiply-adds, 4 W^2 + W per
Montgomery product, at 64 per clock per SM.  The integer rate is an
assumption (the data sheet gives no 32-bit integer multiply-add peak):
the IMAD issue rate of 16 per clock per SM partition, 4 partitions.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

PEAKS = {
    # NVIDIA's data sheet, H100 SXM5: 80 GB HBM3 at 3.35 TB/s, 132 SMs,
    # 1980 MHz boost clock; a 700 W power limit
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12, sms=132,
                                  sm_clock_hz=1.98e9, madd_per_clock_sm=64),
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def peaks(card: str) -> dict:
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])


def int_rate(card: str = DEFAULT_CARD) -> float:
    """32-bit multiply-adds per second."""
    pk = peaks(card)
    return pk["madd_per_clock_sm"] * pk["sms"] * pk["sm_clock_hz"]


def bound_s(nbytes: float, nops: float, card: str = DEFAULT_CARD
            ) -> Tuple[float, str]:
    """The least time the card could take, and which of the two bounds it."""
    t_bytes = nbytes / peaks(card)["hbm_bytes_per_s"]
    t_ops = nops / int_rate(card)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mont_madds(W: int) -> int:
    """32-bit multiply-adds of one Montgomery product at W limbs (CIOS)."""
    return 4 * W * W + W


def scan_work(W: int, ncomp: int, npts: int, pt_inf_sorted, sd, m: int,
              nbuckets: int) -> Tuple[int, int, int]:
    """(bytes, multiply-adds, madds) that the bucket scan needs on this
    data: one mixed addition of 11 coordinate products (1 Montgomery
    product each over Fp, 3 over Fp2) at every position that neither
    restarts a run (a new |digit| or a block's first position) nor holds
    a point at infinity.  sd: (nwin, n) sorted signed digits;
    pt_inf_sorted: (nwin, n) bool, the infinity flag of each position's
    point; ncomp 1 for Fp coordinates, 2 for Fp2."""
    import torch

    nwin, n = sd.shape
    a = sd.abs()
    restart = torch.ones_like(a, dtype=torch.bool)
    restart[:, 1:] = a[:, 1:] != a[:, :-1]
    restart[:, ::m] = True
    madds = int((~restart & ~pt_inf_sorted).sum())
    prods = 11 * (1 if ncomp == 1 else 3)
    nops = madds * prods * mont_madds(W)
    elem = 4 * W * ncomp
    nbytes = (2 * elem * npts + npts + 8 * nwin * n
              + 3 * elem * nwin * (nbuckets + 1 + n // m))
    return nbytes, nops, madds


def ntt_work(W: int, log_n: int) -> Tuple[int, int]:
    """(bytes, multiply-adds) of one radix-2 transform of 2^log_n elements:
    one product per pair per stage whose twiddle is not one, that is
    (m/2 - 1) n + 1 products; the data read and written once, every
    stage table (n - 1 twiddles in all) read once.  The bit-reversal
    gather is not counted."""
    n = 1 << log_n
    prods = log_n * (n // 2) - (n - 1)
    nbytes = 2 * 4 * W * n + 4 * W * (n - 1)
    return nbytes, prods * mont_madds(W)


# -- profiler records ------------------------------------------------------------

def kernel_name(name: str) -> str:
    """A kernel's name without return type, arguments and namespaces, cut
    to 100 characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i][:100]
    return name[:100]


def busy_ns(kernels: Iterable[Tuple[str, int, int]]) -> int:
    """Nanoseconds in which at least one kernel ran: the union of the
    (name, start ns, duration ns) intervals."""
    busy, end = 0, None
    for s, d in sorted((ts, dur) for _, ts, dur in kernels):
        if end is None or s > end:
            busy += d
            end = s + d
        elif s + d > end:
            busy += s + d - end
            end = s + d
    return busy


def by_name(kernels: Iterable[Tuple[str, int, int]]) -> Dict[str, List[int]]:
    """{short name: [summed ns, count]}."""
    out: Dict[str, List[int]] = {}
    for name, _, dur in kernels:
        row = out.setdefault(kernel_name(name), [0, 0])
        row[0] += dur
        row[1] += 1
    return out


def idle_by_label(kernels: List[Tuple[str, int, int]],
                  labels: List[Tuple[str, int, int]],
                  t0: int, t1: int) -> Dict[str, int]:
    """Device idle ns inside [t0, t1], each gap charged to the innermost
    host label (name, start, duration) open at the gap's middle, or to
    "other"."""
    gaps, end = [], t0
    for s, d in sorted((ts, dur) for _, ts, dur in kernels):
        if s > end:
            gaps.append((end, s))
        end = max(end, s + d)
    if t1 > end:
        gaps.append((end, t1))
    labels = sorted(labels, key=lambda x: (x[1], -x[2]))
    out: Dict[str, int] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        best: Optional[Tuple[str, int, int]] = None
        for lab in labels:
            if lab[1] > mid:
                break
            if lab[1] + lab[2] >= mid and (best is None or lab[2] <= best[2]):
                best = lab
        key = best[0] if best else "other"
        out[key] = out.get(key, 0) + (b - a)
    return out
