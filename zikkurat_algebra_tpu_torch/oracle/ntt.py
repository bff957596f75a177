"""Number-theoretic transform on Python ints: the reference the port's
NTT is checked against.

Convention: `ntt` evaluates the coefficient vector on the subgroup
generated by `gen` (size n = 2^m), out[k] = sum_j in[j] * gen^(j k);
`intt` is its inverse and divides by n.
"""

from __future__ import annotations

from typing import List, Sequence

from ..errors import DomainSizeError


def ntt(p: int, gen: int, xs: Sequence[int]) -> List[int]:
    n = len(xs)
    if n & (n - 1) or pow(gen, n, p) != 1:
        raise DomainSizeError(f"NTT of length {n}: not a power of two, or "
                              "gen^n != 1")
    return _ntt_rec(p, gen, [x % p for x in xs])


def intt(p: int, gen: int, xs: Sequence[int]) -> List[int]:
    n = len(xs)
    out = ntt(p, pow(gen, -1, p), xs)
    ninv = pow(n, -1, p)
    return [x * ninv % p for x in out]


def _ntt_rec(p: int, gen: int, xs: List[int]) -> List[int]:
    n = len(xs)
    if n == 1:
        return xs
    evens = _ntt_rec(p, gen * gen % p, xs[0::2])
    odds = _ntt_rec(p, gen * gen % p, xs[1::2])
    out = [0] * n
    tw = 1
    for k in range(n // 2):
        t = tw * odds[k] % p
        out[k] = (evens[k] + t) % p
        out[k + n // 2] = (evens[k] - t) % p
        tw = tw * gen % p
    return out


def subgroup_gen(params, log2_size: int) -> int:
    """Generator of the subgroup of order 2^log2_size, by squaring down
    from the generator of the field's largest FFT domain."""
    if params.fft_domain is None:
        raise DomainSizeError(f"{params.name} has no FFT domain")
    max_log2, g = params.fft_domain
    if not 0 <= log2_size <= max_log2:
        raise DomainSizeError(f"{params.name} has no domain of size "
                              f"2^{log2_size} (largest 2^{max_log2})")
    for _ in range(max_log2 - log2_size):
        g = g * g % params.p
    return g
