"""The plain reference of the EIP-4844 blob prover: the functions of
consensus-specs `specs/deneb/polynomial-commitments.md` transcribed on
Python ints over `bls.py`.

The blob length n is a parameter (the spec's FIELD_ELEMENTS_PER_BLOB is
4096), so that small blobs can be checked too.  A setup here is of a
known tau: the spec's `g1_lincomb` over `KZG_SETUP_G1_LAGRANGE` becomes
the scalar sum_i a_i L_brp(i)(tau) times the generator, so a commitment
is [p(tau)] G1 and a proof [q(tau)] G1, q the spec's quotient in
evaluation form.  Points are the ZCash 48-byte compressed encoding.
`bit_reversed=False` gives the classic slip (the natural-order setup and
roots), the control of the benchmark's blob cell.  Standalone: it
imports neither the port nor JAX.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

from . import bls

BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_G1 = 48
FIELD_ELEMENTS_PER_BLOB = 4096
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"


# -- the domain -----------------------------------------------------------------

def reverse_bits(i: int, n: int) -> int:
    """i with its log2(n) bits reversed."""
    return int(format(i, f"0{n.bit_length() - 1}b")[::-1], 2) if n > 1 else 0


def bit_reversal_permutation(seq: Sequence) -> list:
    """[seq[reverse_bits(i, n)] for i < n]."""
    n = len(seq)
    if n & (n - 1):
        raise ValueError(f"length {n} is not a power of two")
    return [seq[reverse_bits(i, n)] for i in range(n)]


@lru_cache(maxsize=None)
def roots_of_unity(n: int, bit_reversed: bool = True) -> Tuple[int, ...]:
    """The n-th roots of unity w^i, w = 7^((r - 1) / n), in the spec's
    bit-reversed order (or natural order)."""
    roots = bls.domain(n)
    return tuple(bit_reversal_permutation(roots) if bit_reversed else roots)


@lru_cache(maxsize=8)
def lagrange_at_tau(tau: int, n: int, bit_reversed: bool = True
                    ) -> Tuple[int, ...]:
    """L_j(tau) in the setup's order: the discrete logs of the spec's
    bit_reversal_permutation(KZG_SETUP_G1_LAGRANGE)."""
    lag = bls.lagrange_at(tau, n)
    return tuple(bit_reversal_permutation(lag) if bit_reversed else lag)


# -- bytes ----------------------------------------------------------------------

def bytes_to_bls_field(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    if v >= bls.R:
        raise ValueError("field element not below the modulus")
    return v


def blob_to_polynomial(blob: bytes, n: int = FIELD_ELEMENTS_PER_BLOB
                       ) -> List[int]:
    if len(blob) != n * BYTES_PER_FIELD_ELEMENT:
        raise ValueError(f"a blob of {len(blob)} bytes, not "
                         f"{n * BYTES_PER_FIELD_ELEMENT}")
    w = BYTES_PER_FIELD_ELEMENT
    return [bytes_to_bls_field(blob[i * w:(i + 1) * w]) for i in range(n)]


def polynomial_to_blob(values: Sequence[int]) -> bytes:
    return b"".join(int(v).to_bytes(BYTES_PER_FIELD_ELEMENT, "big")
                    for v in values)


def g1_to_bytes48(pt: bls.Affine) -> bytes:
    """The ZCash compressed encoding: big-endian x with flag bits 0x80
    (compressed), 0x40 (infinity) and 0x20 (y is the larger of y and
    p - y) in the first byte."""
    if pt is None:
        return bytes([0xC0]) + bytes(BYTES_PER_G1 - 1)
    x, y = pt
    out = bytearray(x.to_bytes(BYTES_PER_G1, "big"))
    out[0] |= 0x80 | (0x20 if 2 * y >= bls.P else 0)
    return bytes(out)


def g1_from_bytes48(b: bytes) -> bls.Affine:
    """The inverse of `g1_to_bytes48` (py_ecc's decompress_G1): raises on
    a malformed encoding or an x of no curve point."""
    if len(b) != BYTES_PER_G1:
        raise ValueError("not 48 bytes")
    z = int.from_bytes(b, "big")
    c_flag, b_flag, a_flag = (z >> 383) & 1, (z >> 382) & 1, (z >> 381) & 1
    x = z & ((1 << 381) - 1)
    if not c_flag:
        raise ValueError("not compressed")
    if b_flag != (x == 0):
        raise ValueError("infinity flag does not match x")
    if b_flag:
        if a_flag:
            raise ValueError("infinity with the sign flag")
        return None
    if x >= bls.P:
        raise ValueError("x not below p")
    rhs = (x * x * x + bls.B) % bls.P
    y = pow(rhs, (bls.P + 1) // 4, bls.P)
    if y * y % bls.P != rhs:
        raise ValueError("no point has this x")
    if (2 * y >= bls.P) != bool(a_flag):
        y = bls.P - y
    return x, y


# -- the spec's functions ---------------------------------------------------------

def compute_challenge(blob: bytes, commitment: bytes,
                      n: int = FIELD_ELEMENTS_PER_BLOB) -> int:
    """SHA-256 of the domain tag, n as 16 big-endian bytes, the blob and
    the commitment, taken mod r."""
    data = (FIAT_SHAMIR_PROTOCOL_DOMAIN + n.to_bytes(16, "big") + blob
            + commitment)
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % bls.R


def evaluate_polynomial_in_evaluation_form(
        poly: Sequence[int], z: int, bit_reversed: bool = True) -> int:
    """p(z) by the barycentric formula over the bit-reversed roots, or the
    value itself where z is a root."""
    n = len(poly)
    roots = roots_of_unity(n, bit_reversed)
    if z in roots:
        return poly[roots.index(z)]
    inv = bls.batch_inv([(z - w) % bls.R for w in roots])
    s = sum(p * w % bls.R * d for p, w, d in zip(poly, roots, inv)) % bls.R
    return s * (pow(z, n, bls.R) - 1) * pow(n, -1, bls.R) % bls.R


def compute_quotient_eval_within_domain(
        z: int, poly: Sequence[int], y: int, bit_reversed: bool = True) -> int:
    """q(z) for z a root: sum over the other roots w_i of
    (p_i - y) w_i / (z (z - w_i))."""
    roots = roots_of_unity(len(poly), bit_reversed)
    others = [(p, w) for p, w in zip(poly, roots) if w != z]
    inv = bls.batch_inv([z * (z - w) % bls.R for _, w in others])
    return sum((p - y) * w % bls.R * d for (p, w), d in zip(others, inv)
               ) % bls.R


def compute_kzg_proof_impl(poly: Sequence[int], z: int,
                           bit_reversed: bool = True
                           ) -> Tuple[List[int], int]:
    """(the quotient in evaluation form, y = p(z))."""
    roots = roots_of_unity(len(poly), bit_reversed)
    y = evaluate_polynomial_in_evaluation_form(poly, z, bit_reversed)
    inv = bls.batch_inv([(w - z) % bls.R or 1 for w in roots])
    q = [(p - y) * d % bls.R if w != z else
         compute_quotient_eval_within_domain(z, poly, y, bit_reversed)
         for p, w, d in zip(poly, roots, inv)]
    return q, y


# -- commitments and proofs of a known tau ------------------------------------------

def lincomb_scalar(values: Sequence[int], tau: int,
                   bit_reversed: bool = True) -> int:
    """The discrete log of g1_lincomb(setup points, values)."""
    lag = lagrange_at_tau(tau, len(values), bit_reversed)
    return sum(v * l for v, l in zip(values, lag)) % bls.R


class Prover:
    """blob_to_kzg_commitment and compute_blob_kzg_proof for a setup of a
    known tau, with n elements a blob."""

    def __init__(self, tau: int, n: int = FIELD_ELEMENTS_PER_BLOB,
                 bit_reversed: bool = True,
                 fixed_base: Optional[bls.FixedBase] = None):
        self.tau, self.n, self.bit_reversed = tau, n, bit_reversed
        self.fb = fixed_base or bls.FixedBase()

    def commit(self, blob: bytes) -> bytes:
        poly = blob_to_polynomial(blob, self.n)
        c = lincomb_scalar(poly, self.tau, self.bit_reversed)
        return g1_to_bytes48(self.fb.mul(c))

    def kzg_proof(self, poly: Sequence[int], z: int) -> Tuple[bytes, int]:
        """compute_kzg_proof_impl: (the proof's bytes, y)."""
        q, y = compute_kzg_proof_impl(poly, z, self.bit_reversed)
        return g1_to_bytes48(self.fb.mul(
            lincomb_scalar(q, self.tau, self.bit_reversed))), y

    def blob_proof(self, blob: bytes, commitment: bytes) -> bytes:
        pt = g1_from_bytes48(commitment)        # bytes_to_kzg_commitment
        if bls.g1_mul(bls.R, pt) is not None:
            raise ValueError("commitment not in the subgroup")
        poly = blob_to_polynomial(blob, self.n)
        z = compute_challenge(blob, commitment, self.n)
        return self.kzg_proof(poly, z)[0]

    def prove(self, blob: bytes) -> Tuple[bytes, bytes]:
        """(commitment, blob proof), 48 bytes each."""
        c = self.commit(blob)
        return c, self.blob_proof(blob, c)
