"""The prover's polynomial product: `PolyOps.mul_ntt` of two polynomials of
2^(log2_domain - 1) coefficients (two forward NTTs and one inverse of
the domain through K5, K1 and the bit-reversal gather), the operands
drawn from a pool on the device larger in all than the card's L2.

Judged on a sample of the window's products (a reservoir drawn from the
seed): every coefficient canonical (below r), the length 2^d - 1, and
c(z) = a(z) b(z) at a point z drawn from the seed, the reference
evaluating the benchmark's own operands (standard form, drawn again from
the seed) on Python ints; a product that differs anywhere fails this but
with probability below 2^-230.  The control leaves the product's
coefficients unreduced where they fit (c + r below 2^256: the lazy
reduction a faster product would be tempted by).
"""

from __future__ import annotations

from typing import List

import numpy as np

from zkbench import bls, inputs
from zkbench.counts import ntt_work
from zkbench.operation import PORT, OperationBase


def _below(limbs: np.ndarray, mod: int) -> bool:
    """Every value of (W, n) int32 limb planes is below mod."""
    a = limbs.view(np.uint32).astype(np.uint64)
    W = a.shape[0]
    lt = np.zeros(a.shape[1], dtype=bool)
    eq = np.ones(a.shape[1], dtype=bool)
    for j in range(W - 1, -1, -1):
        m = (mod >> (32 * j)) & 0xFFFFFFFF
        lt |= eq & (a[j] < m)
        eq &= a[j] == m
    return bool(lt.all())


class Operation(OperationBase):
    LABELS = {f"{PORT}.ops.ntt:NTTDomain.ntt": "ntt",
              f"{PORT}.ops.ntt:NTTDomain.intt": "intt",
              f"{PORT}.ops.field:Field.mul": "pointwise_mul"}
    NEED_RECORDS = ("ntt_stages",)
    STATE = ("pool",)

    def setup(self):
        from zikkurat_algebra_tpu_torch import api

        self.api = api.bls12_381(self.device)
        self.log_n = self.config["log2_domain"]
        self.n = 1 << (self.log_n - self.mix["operands_below_domain_log2"])
        fr = self.api.fr
        self.pool = [fr.to_mont(self._operand(j))
                     for j in range(self.mix["pool"])]
        self.sample = self.mix["judge_ops"]
        self.pick = inputs.rng(self.seed, 4)
        self.count = 0

    def _operand(self, j: int):
        g = inputs.torch_gen(self.seed, self.device, 3, j)
        return inputs.uniform_limbs(g, bls.R, self.n, self.device)

    def inputs(self, i: int):
        j, k = inputs.rng(self.seed, 2, i).integers(self.mix["pool"], size=2)
        return int(j), int(k)

    def run(self, jk, tracer):
        j, k = jk
        return self.api.poly.mul_ntt(self.pool[j], self.pool[k])

    def keep(self, i: int, jk, out) -> None:
        """Reservoir sampling: after t products each is held with
        probability sample / t."""
        self.count += 1
        if len(self.kept) < self.sample:
            self.kept.append((i, jk, out.clone()))
        else:
            slot = int(self.pick.integers(self.count))
            if slot < self.sample:
                self.kept[slot] = (i, jk, out.clone())

    def kernel_work(self, jk) -> dict:
        nbytes, nops = ntt_work(8, self.log_n)
        return {"k5": (3 * nbytes, 3 * nops)}

    # -- judgement ----------------------------------------------------------------
    def answers(self) -> List[tuple]:
        return [(i, jk, out.cpu().numpy()) for i, jk, out in self.kept]

    def control_answers(self) -> List[tuple]:
        out = []
        for i, jk, c in self.answers():
            vals = inputs.limbs_to_ints(c)
            lazy = [v + bls.R if v + bls.R < 1 << 256 else v for v in vals]
            out.append((i, jk, inputs.ints_to_limbs(lazy, 8)))
        return out

    def compare(self, answers) -> List[dict]:
        z = int.from_bytes(inputs.rng(self.seed, 5).bytes(40), "little") % bls.R
        r_inv = pow(1 << 256, -1, bls.R)
        at_z = {}

        def operand_at_z(j):
            if j not in at_z:
                at_z[j] = bls.eval_coeffs(
                    inputs.limbs_to_ints(self._operand(j)), z)
            return at_z[j]

        wrong = 0
        for i, (j, k), c in answers:
            ok = (c.shape[-1] == 2 * self.n - 1 and _below(c, bls.R)
                  and bls.eval_coeffs(inputs.limbs_to_ints(c), z) * r_inv
                  % bls.R == operand_at_z(j) * operand_at_z(k) % bls.R)
            wrong += not ok
        return [dict(name="wrong_products", value=wrong, limit=0)]
