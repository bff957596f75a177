"""The optimal-Ate pairing on limb planes (BN128 and BLS12-381).

The torch counterpart of zikkurat_algebra_tpu/ops/pairing.py::
PairingKernels, batched over the last axes of its inputs:

* The Miller loop runs over the twist: T stays projective over Fp2 and
  moves by the complete G2 formulas of ops/curve.py (RCB15, the same
  operation order as the JAX package, so T and f equal the JAX values
  step by step).  Line values carry no denominators; the factors left
  out lie in Fp2* and die in the final exponentiation.  The sparse line
  is placed by twist type (D-type for BN, M-type for BLS).  For BN two
  more line steps add pi(Q) and -pi^2(Q) (the G2 Frobenius map).  For
  the negative BLS seed f is not conjugated, as in the reference.
* The final exponentiation: the easy part (p^6 - 1)(p^2 + 1) by the
  conjugation, one Fp12 inverse and a Frobenius map; the hard part
  (p^4 - p^2 + 1) / r by a simultaneous multi-exponentiation over its
  J = 4 base-p digits: the 2^J subset products of y^(p^j) are tabulated,
  then each of about log2 p steps is one cyclotomic squaring and one
  product by the table entry of the step's digit bits.

The loop bits and the hard part's subset indices are host ints, so the
JAX package's `lax.scan` / `lax.cond` / table gather become Python loops,
`if`s and list indexing, and nothing is read back from the device.
Every Fp12 product is one K1 launch (54 base products per element).
Spans (`utils.profiling`): `pairing.miller_loop`, `pairing.final_exp`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..errors import UnsupportedError
from ..oracle.pairing import Pairing as OraclePairing
from ..params import CurveParams
from .curve import AffBatch, CurveKernels, Point, get_curves
from ..utils import profiling as prof
from .field import resolve_device


class PairingKernels:
    def __init__(self, curve: CurveParams, device="cuda"):
        self.curve = curve
        self.ck: CurveKernels = get_curves(curve, device)
        self.tower = self.ck.tower
        self.device = self.ck.device
        self.oracle = OraclePairing(curve)
        p = curve.fp.p
        t = self.tower
        # the G2 Frobenius map (x, y) -> (conj x g_x, conj y g_y) with
        # g_x = xi^(+-(p-1)/3), g_y = xi^(+-(p-1)/2): + for the D-type
        # untwist (BN), - for the M-type (BLS)
        o2 = self.oracle.tower.fp2
        sign = 1 if curve.family == "bn" else -1
        self.gx_const = t.encode_fp2_const(o2.pow(o2.xi, sign * (p - 1) // 3))
        self.gy_const = t.encode_fp2_const(o2.pow(o2.xi, sign * (p - 1) // 2))
        # Miller loop bits of |s|, MSB first, the leading 1 dropped
        self.loop_bits = [int(b) for b in bin(curve.ate_loop_count)[3:]]
        # the hard exponent (p^4 - p^2 + 1) / r as base-p digits e_j, and
        # per step (MSB first) the subset {j : bit of e_j set}
        self.hard_exp = (p ** 4 - p ** 2 + 1) // curve.fr.p
        digits, h = [], self.hard_exp
        while h:
            digits.append(h % p)
            h //= p
        self.hard_digits = digits
        steps = max(d.bit_length() for d in digits)
        self.hard_subset_idx = [
            sum(((d >> s) & 1) << j for j, d in enumerate(digits))
            for s in range(steps - 1, -1, -1)]
        # the doubled terms the cyclotomic square subtracts: -2 U0, -2 W0
        # (row 0) and -2 V1 (row 1)
        self._cyc_neg = torch.tensor([[True, False, True],
                                      [False, True, False]],
                                     device=self.device).view(1, 1, 2, 3)

    # -- G2 Frobenius and lines --------------------------------------------------
    @staticmethod
    def _const2(c, like):
        """A (W, 2) Fp2 constant broadcast against an Fp2 batch."""
        return c.view(c.shape + (1,) * (like.ndim - 2)).expand(like.shape)

    def g2_frobenius(self, xy: Tuple[torch.Tensor, torch.Tensor]):
        """phi(x, y) = (g_x conj x, g_y conj y) on affine Fp2 coordinates,
        both products in one launch."""
        f2 = self.tower.fp2
        x, y = xy
        return tuple(f2.mul_list([(f2.conj(x), self._const2(self.gx_const, x)),
                                  (f2.conj(y), self._const2(self.gy_const, y))]))

    def _sparse12(self, c_y, c_x, c_base):
        """The line value as a full Fp12 element: w-slot i, v-slot j holds
        w^(i + 2 j); D-type puts c_y, c_x, c_base at w^0, w^1, w^3,
        M-type c_base, c_x, c_y at w^0, w^2, w^3."""
        z = torch.zeros_like(c_y)
        if self.curve.family == "bn":
            w0, w1, w2, w3 = c_y, c_x, z, c_base
        else:
            w0, w1, w2, w3 = c_base, z, c_x, c_y
        return torch.stack([torch.stack([w0, w2, z], 1),
                            torch.stack([w1, w3, z], 1)], 1)

    def _line_dbl(self, T: Point, xp, yp):
        """The doubling step's line at P = (xp, yp) for projective T:
        (2 Y Z^2 yp, -3 X^2 Z xp, 3 X^3 - 2 Y^2 Z), in three launches."""
        f2 = self.tower.fp2
        X, Y, Z = T
        Ysq, Xsq, YZ = f2.mul_list([(Y, Y), (X, X), (Y, Z)])
        YZ2, Xsq2, Ysq2 = f2.add_list([(YZ, YZ), (Xsq, Xsq), (Ysq, Ysq)])
        X3, yzz, t3x2z, y2z = f2.mul_list([
            (Xsq, X), (YZ2, Z), (f2.add(Xsq2, Xsq), Z), (Ysq2, Z)])
        c_y, c_x = f2.scale_base(torch.stack([yp, xp], 1),
                                 torch.stack([yzz, t3x2z], 2)).unbind(2)
        t3x3 = f2.add(f2.add(X3, X3), X3)
        return c_y, f2.neg(c_x), f2.sub(t3x3, y2z)

    def _line_add(self, T: Point, Q: Tuple[torch.Tensor, torch.Tensor], xp,
                  yp):
        """The mixed-addition step's line: theta = Y - yq Z,
        lam = X - xq Z; (lam yp, -theta xp, theta xq - lam yq)."""
        f2 = self.tower.fp2
        X, Y, Z = T
        xq, yq = Q
        yqZ, xqZ = f2.mul_list([(yq, Z), (xq, Z)])
        theta, lam = f2.sub_list([(Y, yqZ), (X, xqZ)])
        c_y, c_x = f2.scale_base(torch.stack([yp, xp], 1),
                                 torch.stack([lam, theta], 2)).unbind(2)
        txq, lyq = f2.mul_list([(theta, xq), (lam, yq)])
        return c_y, f2.neg(c_x), f2.sub(txq, lyq)

    # -- Miller loop ---------------------------------------------------------------
    def miller_loop(self, P: AffBatch, Q: AffBatch) -> torch.Tensor:
        """f_{s,Q}(P) up to Fp2* factors, (W, 2, 3, 2, *batch), for affine
        G1 points P (x (W, *batch)) and G2 points Q (x (W, 2, *batch))."""
        with prof.span("pairing.miller_loop", self.device):
            f12, f2 = self.tower.fp12, self.tower.fp2
            g2 = self.ck.g2
            xp, yp, _ = P
            xq, yq, _ = Q
            batch = tuple(xp.shape[1:])
            f = f12.one(batch)
            T = g2.from_affine(Q)
            for bit in self.loop_bits:
                line = self._sparse12(*self._line_dbl(T, xp, yp))
                T = g2.dbl(T)
                f = f12.mul(f12.sqr(f), line)
                if bit:
                    line = self._sparse12(
                        *self._line_add(T, (xq, yq), xp, yp))
                    T = g2.madd(T, Q)
                    f = f12.mul(f, line)
            if self.curve.family == "bn":
                # T += pi(Q), T += -pi^2(Q)
                pi_q = self.g2_frobenius((xq, yq))
                x2, y2 = self.g2_frobenius(pi_q)
                finite = torch.zeros(batch, dtype=torch.bool,
                                     device=xp.device)
                for q in (pi_q, (x2, f2.neg(y2))):
                    line = self._sparse12(*self._line_add(T, q, xp, yp))
                    T = g2.madd(T, (q[0], q[1], finite))
                    f = f12.mul(f, line)
            return f

    # -- final exponentiation ---------------------------------------------------------
    def cyclotomic_sqr(self, a: torch.Tensor) -> torch.Tensor:
        """The Granger-Scott square of an element of the cyclotomic
        subgroup: three Fp4 squares over Fp4 = Fp2[z] / (z^2 - xi),
        z = w^3, on the coefficient pairs U = (c0, c3), V = (c1, c4),
        W = (c2, c5) of w^0 .. w^5; the nine Fp2 products in one launch
        (pairing.py:216).  The doubled terms are plain sums (canonical
        limbs need no Montgomery product by 2)."""
        t = self.tower
        f2 = t.fp2
        # X0 = (U0, V0, W0) = (c0, c1, c2), X1 = (U1, V1, W1) = (c3, c4, c5)
        X0 = torch.stack([a[:, 0, 0], a[:, 1, 0], a[:, 0, 1]], 2)
        X1 = torch.stack([a[:, 1, 1], a[:, 0, 2], a[:, 1, 2]], 2)
        x0s, x1s, x01 = f2.mul_list([(X0, X0), (X1, X1), (X0, X1)])
        s0, s1 = f2.add_list([(x0s, t.mul_xi(x1s)), (x01, x01)])
        # first halves 3 (sU0, zW0, sV0) + (-2 U0, 2 V0, -2 W0), second
        # halves 3 (sU1, zW1, sV1) + (2 U1, -2 V1, 2 W1), where
        # (zW0, zW1) = z sq(W) = (xi sW1, sW0)
        Y = torch.stack([
            torch.stack([s0[:, :, 0], t.mul_xi(s1[:, :, 2]), s0[:, :, 1]], 2),
            torch.stack([s1[:, :, 0], s0[:, :, 2], s1[:, :, 1]], 2)], 2)
        X = torch.stack([X0, X1], 2)
        D = f2.add(X, X)
        neg = self._cyc_neg.view(self._cyc_neg.shape + (1,) * (D.ndim - 4))
        D = torch.where(neg, f2.neg(D), D)
        o = f2.add(f2.times(Y, 3), D)                  # (W, 2, 2, 3, *batch)
        lo, hi = o[:, :, 0], o[:, :, 1]
        return torch.stack([
            torch.stack([lo[:, :, 0], lo[:, :, 2], hi[:, :, 1]], 1),
            torch.stack([lo[:, :, 1], hi[:, :, 0], hi[:, :, 2]], 1)], 1)

    def final_exp(self, f: torch.Tensor) -> torch.Tensor:
        """f^((p^12 - 1) / r) (pairing.py:263)."""
        with prof.span("pairing.final_exp", self.device):
            t = self.tower
            f12 = t.fp12
            # easy part: f^(p^6 - 1) = conj(f) / f, then ^(p^2 + 1)
            f1 = f12.mul(t.fp12_conj(f), f12.inv(f))
            y = f12.mul(t.fp12_frobenius(f1, 2), f1)
            J = len(self.hard_digits)
            bases = [y]
            for _ in range(1, J):
                bases.append(t._frob1(bases[-1]))
            # subset products T[s] = prod_{j in s} bases[j], one launch per
            # subset size
            T = {1 << j: b for j, b in enumerate(bases)}
            for size in range(2, J + 1):
                todo = [s for s in range(1, 1 << J)
                        if bin(s).count("1") == size]
                pairs = []
                for s in todo:
                    j = (s & -s).bit_length() - 1     # the lowest element
                    pairs.append((T[s & (s - 1)], bases[j]))
                for s, v in zip(todo, f12.mul_list(pairs)):
                    T[s] = v
            acc = None
            for i in self.hard_subset_idx:
                if acc is not None:
                    acc = self.cyclotomic_sqr(acc)
                if i:
                    acc = T[i] if acc is None else f12.mul(acc, T[i])
            return f12.one(f.shape[4:]).contiguous() if acc is None else acc

    # -- pairings ---------------------------------------------------------------------
    def pairing(self, P: AffBatch, Q: AffBatch) -> torch.Tensor:
        """e(P_i, Q_i) for every pair of the batch; 1 where P or Q is at
        infinity."""
        f12 = self.tower.fp12
        out = self.final_exp(self.miller_loop(P, Q))
        return f12.select(P[2] | Q[2], f12.one(out.shape[4:]), out)

    def pairing_product(self, P: AffBatch, Q: AffBatch) -> torch.Tensor:
        """prod_i e(P_i, Q_i) over a 1-D batch: the Miller values
        multiplied by a tree (an odd level padded with 1), then ONE final
        exponentiation.  Returns one Fp12 element (W, 2, 3, 2)."""
        f12 = self.tower.fp12
        f = self.miller_loop(P, Q)
        f = f12.select(P[2] | Q[2], f12.one(f.shape[4:]), f)
        while f.shape[-1] > 1:
            k = f.shape[-1]
            if k % 2:
                f = torch.cat([f, f12.one((1,))], -1)
                k += 1
            f = f12.mul(f[..., :k // 2], f[..., k // 2:])
        return self.final_exp(f[..., 0])


_PAIRING_CACHE: Dict[Tuple[CurveParams, torch.device], PairingKernels] = {}


def get_pairing(curve: CurveParams, device="cuda") -> PairingKernels:
    """The PairingKernels of `curve` on `device`, built once; a family
    without G2 (BLS12-377) raises UnsupportedError."""
    if curve.b2 is None:
        raise UnsupportedError(f"{curve.name} has no G2 and no pairing "
                               "(fields + tower + G1 only)")
    key = (curve, resolve_device(device))
    if key not in _PAIRING_CACHE:
        _PAIRING_CACHE[key] = PairingKernels(curve, key[1])
    return _PAIRING_CACHE[key]
