"""The optimal-Ate pairing on Python ints: slow, affine, trusted.

The anchor of the port's pairing (ops/pairing.py).  It untwists G2 into
E(Fp12) (BN, D-type: psi(x, y) = (x w^2, y w^3); BLS, M-type:
psi(x, y) = (x w^-2, y w^-3)), runs a textbook affine Miller loop WITH
the vertical-line denominators, and raises to (p^12 - 1) / r directly.
Its Miller values differ from the projective loop's by factors in Fp2*
that the final exponentiation kills; the pairing values agree.  As in
the reference, f is not conjugated for the negative BLS seed.
"""

from __future__ import annotations

from ..params import CurveParams
from .ext import Tower


class Pairing:
    def __init__(self, curve: CurveParams):
        self.cp = curve
        self.tower = Tower(curve)
        f12, f6, f2 = self.tower.fp12, self.tower.fp6, self.tower.fp2
        self.f12 = f12
        w = (f6.zero, (f2.one, f2.zero, f2.zero))
        self.w2 = f12.sqr(w)
        self.w3 = f12.mul(self.w2, w)
        self.inv_w2 = f12.inv(self.w2)
        self.inv_w3 = f12.inv(self.w3)
        self.final_exponent = (curve.fp.p ** 12 - 1) // curve.fr.p

    # -- embeddings ------------------------------------------------------------
    def embed_fp(self, a: int):
        f2, f6 = self.tower.fp2, self.tower.fp6
        return (((a % self.tower.fp.p, 0), f2.zero, f2.zero), f6.zero)

    def embed_fp2(self, a):
        f2, f6 = self.tower.fp2, self.tower.fp6
        return ((a, f2.zero, f2.zero), f6.zero)

    def psi(self, q):
        """The untwist G2(Fp2) -> E(Fp12)."""
        if q is None:
            return None
        f12 = self.f12
        x, y = self.embed_fp2(q[0]), self.embed_fp2(q[1])
        if self.cp.family == "bn":
            return (f12.mul(x, self.w2), f12.mul(y, self.w3))
        return (f12.mul(x, self.inv_w2), f12.mul(y, self.inv_w3))

    def psi_inv(self, pt):
        """E(Fp12) -> G2(Fp2), on the image of psi."""
        if pt is None:
            return None
        f12 = self.f12
        if self.cp.family == "bn":
            x, y = f12.mul(pt[0], self.inv_w2), f12.mul(pt[1], self.inv_w3)
        else:
            x, y = f12.mul(pt[0], self.w2), f12.mul(pt[1], self.w3)
        return (x[0][0], y[0][0])

    def frobenius_g2(self, q):
        """The untwist-Frobenius-twist endomorphism of G2."""
        f12 = self.f12
        x, y = self.psi(q)
        return self.psi_inv((f12.frobenius(x), f12.frobenius(y)))

    # -- affine steps with their line values -------------------------------------
    def _line_dbl(self, t, p):
        """(l_{T,T}(P) / v_{2T}(P), 2T)."""
        f = self.f12
        xt, yt = t
        xp, yp = p
        xx = f.sqr(xt)
        lam = f.div(f.add(f.add(xx, xx), xx), f.add(yt, yt))
        x2 = f.sub(f.sqr(lam), f.add(xt, xt))
        y2 = f.sub(f.mul(lam, f.sub(xt, x2)), yt)
        line = f.sub(f.sub(yp, yt), f.mul(lam, f.sub(xp, xt)))
        return f.div(line, f.sub(xp, x2)), (x2, y2)

    def _line_add(self, t, q, p):
        """(l_{T,Q}(P) / v_{T+Q}(P), T + Q)."""
        f = self.f12
        xt, yt = t
        xq, yq = q
        xp, yp = p
        if f.eq(xt, xq):
            if f.eq(yt, yq):
                return self._line_dbl(t, p)
            return f.sub(xp, xt), None          # vertical: T + Q = infinity
        lam = f.div(f.sub(yq, yt), f.sub(xq, xt))
        x3 = f.sub(f.sub(f.sqr(lam), xt), xq)
        y3 = f.sub(f.mul(lam, f.sub(xt, x3)), yt)
        line = f.sub(f.sub(yp, yt), f.mul(lam, f.sub(xp, xt)))
        return f.div(line, f.sub(xp, x3)), (x3, y3)

    def miller(self, s: int, qe, pe):
        """f_{s,Q}(P) for affine E(Fp12) points, double-and-add."""
        f12 = self.f12
        f, t = f12.one, qe
        for bit in bin(s)[3:]:
            lv, t = self._line_dbl(t, pe)
            f = f12.mul(f12.sqr(f), lv)
            if bit == "1":
                lv, t = self._line_add(t, qe, pe)
                f = f12.mul(f, lv)
        return f, t

    # -- the pairing ------------------------------------------------------------------
    def pairing(self, p1, q2):
        """e(P, Q) for P in G1 (affine ints or None) and Q in G2 (affine
        Fp2 or None): an Fp12 value, 1 at infinity."""
        f12 = self.f12
        if p1 is None or q2 is None:
            return f12.one
        pe = (self.embed_fp(p1[0]), self.embed_fp(p1[1]))
        qe = self.psi(q2)
        f, t = self.miller(self.cp.ate_loop_count, qe, pe)
        if self.cp.family == "bn":
            # T += pi(Q), T += -pi^2(Q)
            pi_q = (f12.frobenius(qe[0]), f12.frobenius(qe[1]))
            pi2_q = (f12.frobenius(pi_q[0]), f12.frobenius(pi_q[1]))
            lv, t = self._line_add(t, pi_q, pe)
            f = f12.mul(f, lv)
            lv, t = self._line_add(t, (pi2_q[0], f12.neg(pi2_q[1])), pe)
            f = f12.mul(f, lv)
        return f12.pow(f, self.final_exponent)

    def gt_pow(self, g, k: int):
        return self.f12.pow(g, k % self.cp.fr.p)
