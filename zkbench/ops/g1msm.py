"""The prover's G1 MSM: `bls12_381().msm_g1.msm_std` of the configuration's
points (the SRS [tau^i] G1 tiled) with fresh scalars uniform below r,
then `to_affine`.

Judged exactly, every operation of the window: with the SRS of a known
tau, sum_j s_j [tau^(j mod m)] G1 = [sum_i S_i tau^i] G1 where S_i sums
the scalars at the positions of point i; the reference forms that
scalar and multiplies the generator on Python ints.  The control drops
every scalar's top 15-bit window (s mod 2^240, a scalar width one window
short).
"""

from __future__ import annotations

from typing import List

from zkbench import bls, inputs
from zkbench.counts import scan_work
from zkbench.operation import PORT, OperationBase

MSM = f"{PORT}.ops.msm"


class Operation(OperationBase):
    LABELS = {f"{MSM}:MSM.group": "digits_and_sort",
              f"{MSM}:bucket_scan": "bucket_scan",
              f"{MSM}:_level2_carries": "level2",
              f"{MSM}:_weighted_bucket_sum": "weighted_sum",
              f"{MSM}:MSM.msm_std": "msm_std_rest (extraction, horner)",
              f"{PORT}.ops.curve:ProjCurveOps.to_affine": "to_affine"}
    NEED_RECORDS = ("bucket_scan",)
    STATE = ("points",)

    def setup(self):
        from zikkurat_algebra_tpu_torch import api

        cfg = self.config
        self.api = api.bls12_381(self.device)
        self.srs = inputs.load_srs(self.root, cfg)
        self.n = cfg["msm_points"]
        m = self.srs["n"]
        if self.n % m:
            raise ValueError(f"{self.n} points do not tile {m} SRS points")
        x, y, inf = self.api.encode_g1(self.srs["tau_g1"])
        reps = self.n // m
        self.points = (x.repeat(1, reps).contiguous(),
                       y.repeat(1, reps).contiguous(),
                       inf.repeat(reps).contiguous())
        self.block = cfg["block"]
        self.c = cfg.get("window_bits")
        self.msm = self.api.msm_g1

    def inputs(self, i: int):
        g = inputs.torch_gen(self.seed, self.device, 1, i)
        return inputs.uniform_limbs(g, bls.R, self.n, self.device)

    def run(self, k, tracer):
        stages = tracer["stages"] if tracer else None
        P = self.msm.msm_std(k, self.points, self.c, self.block,
                             stage_seconds=stages)
        return self.api.g1.to_affine(tuple(t.unsqueeze(-1) for t in P))

    def units(self, args) -> float:
        return float(self.n)

    def kernel_work(self, k) -> dict:
        """K2's bytes and multiply-adds on this operation's data."""
        c, nb, (x, y, inf), sd, idx = self.msm.group(k, self.points, self.c,
                                                     self.block)
        nbytes, nops, _ = scan_work(12, 1, x.shape[-1], inf[idx.long()], sd,
                                    self.block, nb)
        return {"k2": (nbytes, nops)}

    # -- judgement ----------------------------------------------------------------
    def _scalar_sums(self, i: int, top_window: bool = True) -> int:
        k = self.inputs(i)
        if not top_window:
            k[7] &= (1 << 16) - 1                   # s mod 2^240
        m = self.srs["n"]
        sums = inputs.column_sums(k, m)
        return sum(s * t for s, t in zip(sums, bls.powers(self.srs["tau"], m))
                   ) % bls.R

    def answers(self) -> List[tuple]:
        out = []
        for i, (x, y, inf) in self.kept:
            pt = None if bool(inf.reshape(-1)[0]) else (
                inputs.mont_ints(x, bls.P)[0], inputs.mont_ints(y, bls.P)[0])
            out.append((i, pt))
        return out

    def control_answers(self) -> List[tuple]:
        fb = bls.FixedBase()
        return [(i, fb.mul(self._scalar_sums(i, top_window=False)))
                for i, _ in self.kept]

    def compare(self, answers) -> List[dict]:
        fb = bls.FixedBase()
        wrong = sum(fb.mul(self._scalar_sums(i)) != pt for i, pt in answers)
        return [dict(name="wrong_msm_results", value=wrong, limit=0)]
