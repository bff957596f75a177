"""The plain reference: BLS12-381 on Python ints.

Fp, Fr, G1 in Jacobian coordinates (a fixed-base table for the
generator), Fp2 and G2 (affine, slow; only for the frozen setup), and
the scalar side of KZG over a natural-order domain of 2^k: the Lagrange
basis at tau, barycentric evaluation, commitments and proofs as scalars
of the generator.  Standalone: it imports neither the port nor JAX, and
takes nothing the port made.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
B = 4
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)
FR_GENERATOR = 7          # the multiplicative generator of Fr (EIP-4844)
FR_TWO_ADICITY = 32

Affine = Optional[Tuple[int, int]]        # None is the point at infinity


# -- G1: y^2 = x^3 + 4 over Fp, Jacobian (X, Y, Z), Z = 0 at infinity ----------

def on_curve(pt: Affine) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def _dbl(X, Y, Z):
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    A = X * X % P
    Bq = Y * Y % P
    C = Bq * Bq % P
    D = 2 * ((X + Bq) * (X + Bq) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P


def _madd(X1, Y1, Z1, x2, y2):
    """Jacobian + affine (x2, y2); both may be equal or opposite."""
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1 * Z1Z1 % P
    H = (U2 - X1) % P
    rr = (S2 - Y1) % P
    if H == 0:
        return _dbl(X1, Y1, Z1) if rr == 0 else (1, 1, 0)
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (rr * rr - HHH - 2 * V) % P
    Y3 = (rr * (V - X3) - Y1 * HHH) % P
    return X3, Y3, Z1 * H % P


def _to_affine(J) -> Affine:
    X, Y, Z = J
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    z2 = zi * zi % P
    return X * z2 % P, Y * z2 * zi % P


def _batch_to_affine(js: Sequence) -> List[Affine]:
    """Jacobian points to affine with one inversion (Montgomery's trick)."""
    zs = [j[2] if j[2] else 1 for j in js]
    pre, acc = [], 1
    for z in zs:
        pre.append(acc)
        acc = acc * z % P
    inv = pow(acc, -1, P)
    out: List[Affine] = [None] * len(js)
    for i in range(len(js) - 1, -1, -1):
        zi = inv * pre[i] % P
        inv = inv * zs[i] % P
        X, Y, Z = js[i]
        if Z:
            z2 = zi * zi % P
            out[i] = (X * z2 % P, Y * z2 * zi % P)
    return out


def g1_add(a: Affine, b: Affine) -> Affine:
    if a is None:
        return b
    if b is None:
        return a
    return _to_affine(_madd(a[0], a[1], 1, b[0], b[1]))


def g1_neg(a: Affine) -> Affine:
    return None if a is None else (a[0], (-a[1]) % P)


def g1_mul(k: int, pt: Affine) -> Affine:
    """[k] pt by double-and-add (any point, any integer k >= 0)."""
    if pt is None:
        return None
    acc = (1, 1, 0)
    for bit in bin(k)[2:]:
        acc = _dbl(*acc)
        if bit == "1":
            acc = _madd(*acc, *pt)
    return _to_affine(acc)


class FixedBase:
    """[k] G for one base G: a table of d 16^w G (d < 16, w < 64), so a
    product is at most 64 mixed additions and no doubling."""

    def __init__(self, base: Affine = G1_GEN):
        rows = []
        cur = (base[0], base[1], 1)
        for _ in range(64):
            row, acc = [], (1, 1, 0)
            base_aff = _to_affine(cur)
            for _ in range(15):
                acc = _madd(*acc, *base_aff)
                row.append(acc)
            rows.append(row)
            cur = _dbl(*_dbl(*_dbl(*_dbl(*cur))))
        flat = _batch_to_affine([j for row in rows for j in row])
        self.table = [flat[15 * w:15 * (w + 1)] for w in range(64)]

    def jac(self, k: int):
        k %= R
        acc = (1, 1, 0)
        w = 0
        while k:
            d = k & 15
            if d:
                x, y = self.table[w][d - 1]
                acc = _madd(*acc, x, y)
            k >>= 4
            w += 1
        return acc

    def mul(self, k: int) -> Affine:
        return _to_affine(self.jac(k))

    def mul_many(self, ks: Sequence[int]) -> List[Affine]:
        return _batch_to_affine([self.jac(k) for k in ks])


# -- Fp2 = Fp[u] / (u^2 + 1) and G2: y^2 = x^3 + 4 (1 + u) -----------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def f2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return (a[0] * d % P, (-a[1]) * d % P)


G2_B = (4, 4)


def g2_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    rhs = f2_add(f2_mul(f2_mul(x, x), x), G2_B)
    return f2_mul(y, y) == rhs


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0]:
        if f2_add(a[1], b[1]) == (0, 0):
            return None
        x2 = f2_mul(a[0], a[0])
        lam = f2_mul(f2_add(f2_add(x2, x2), x2), f2_inv(f2_add(a[1], a[1])))
    else:
        lam = f2_mul(f2_sub(b[1], a[1]), f2_inv(f2_sub(b[0], a[0])))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), a[0]), b[0])
    return x3, f2_sub(f2_mul(lam, f2_sub(a[0], x3)), a[1])


def g2_mul(k: int, pt):
    acc = None
    for bit in bin(k % R)[2:]:
        acc = g2_add(acc, acc)
        if bit == "1":
            acc = g2_add(acc, pt)
    return acc


# -- Fr and KZG over the natural-order domain of n = 2^k --------------------------

def root_of_unity(n: int) -> int:
    """The generator of the subgroup of order n of Fr*: 7^((r - 1) / n)."""
    if n & (n - 1) or n > 1 << FR_TWO_ADICITY:
        raise ValueError(f"no subgroup of order {n}")
    return pow(FR_GENERATOR, (R - 1) // n, R)


def batch_inv(xs: Sequence[int], mod: int = R) -> List[int]:
    pre, acc = [], 1
    for x in xs:
        pre.append(acc)
        acc = acc * x % mod
    inv = pow(acc, -1, mod)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = inv * pre[i] % mod
        inv = inv * xs[i] % mod
    return out


def domain(n: int) -> List[int]:
    w = root_of_unity(n)
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * w % R
    return out


def lagrange_at(x: int, n: int) -> List[int]:
    """L_i(x) = (x^n - 1) w^i / (n (x - w^i)) for x outside the domain."""
    ws = domain(n)
    inv = batch_inv([n * (x - w) % R for w in ws])
    zn = (pow(x, n, R) - 1) % R
    return [zn * w % R * d % R for w, d in zip(ws, inv)]


def eval_values(values: Sequence[int], x: int) -> int:
    """p(x) for the polynomial that takes values[i] at w^i (barycentric)."""
    return sum(v * l for v, l in zip(values, lagrange_at(x, len(values)))) % R


def eval_coeffs(coeffs: Sequence[int], x: int, mod: int = R) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % mod
    return acc


def powers(x: int, n: int) -> List[int]:
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * x % R
    return out


def kzg_prove(values: Sequence[int], tau: int, x0: int):
    """(commitment scalar p(tau), y0 = p(x0), proof scalar
    (p(tau) - y0) / (tau - x0)) of the blob `values` on the domain."""
    c = eval_values(values, tau)
    y0 = eval_values(values, x0)
    return c, y0, (c - y0) * pow(tau - x0, -1, R) % R


def kzg_valid(c: int, q: int, x0: int, y0: int, tau: int) -> bool:
    """The verifier's equation on discrete logs: e([q], [tau - x0]) equals
    e([c - y0], 1) iff c - y0 = (tau - x0) q mod r."""
    return (c - y0 - (tau - x0) * q) % R == 0
