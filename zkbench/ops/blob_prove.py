"""The EIP-4844 blob prover: per operation a fresh batch of the mix's
`blobs` blobs (a type-3 transaction), each `field_elements_per_blob`
values uniform below r drawn from (seed, i) and serialized to the spec's
bytes in host memory before the timed call; the call runs the port's
`blob_to_kzg_commitments`, then `compute_blob_kzg_proofs`
(`eip4844.prove_blobs`), and returns the commitments and proofs, 48
bytes each, in host memory.

Judged on a sample of the window's operations (a reservoir drawn from
the seed), byte for byte against the plain reference `zkbench/eip4844.py`
on the blob bytes drawn again from the seed: the setup is of a known
tau, so each commitment and proof is a scalar times the generator.  The
control commits and proves the same blobs over the natural-order
Lagrange points and roots, with no bit reversal (the classic slip).
"""

from __future__ import annotations

import contextlib
import functools
from typing import List

import numpy as np
import torch

from zkbench import bls, eip4844, inputs
from zkbench.operation import PORT, OperationBase

EIP = f"{PORT}.protocols.eip4844"


class Operation(OperationBase):
    LABELS = {f"{EIP}:blob_to_kzg_commitments": "commit",
              f"{EIP}:compute_blob_kzg_proofs": "challenge_and_open",
              f"{PORT}.ops.msm:MSM.msm_std": "msm_std",
              f"{PORT}.ops.curve:ProjCurveOps.to_affine": "to_affine",
              f"{PORT}.ops.field:Field.batch_inv": "batch_inv"}
    STATE = ("setup_",)

    def setup(self):
        from zikkurat_algebra_tpu_torch.protocols import eip4844 as port
        from zikkurat_algebra_tpu_torch.utils import profiling

        cfg = self.config
        self.port, self.profiling = port, profiling
        self.n = cfg["field_elements_per_blob"]
        self.tau = int(cfg["tau"], 16)
        srs = inputs.load_srs(self.root, cfg)
        if srs["n"] != self.n:
            raise ValueError(f"a setup of {srs['n']} points for blobs of "
                             f"{self.n} elements")
        self.setup_ = port.load_setup(srs["lagrange_g1"], device=self.device,
                                      window_bits=cfg.get("window_bits"))
        self.blobs = self.mix["blobs"]
        self.sample = self.mix["judge_ops"]
        self.pick = inputs.rng(self.seed, 4)
        self.count = 0

    def _values(self, i: int):
        """The (8, blobs n) values of operation i, uniform below r."""
        g = inputs.torch_gen(self.seed, self.device, 1, i)
        return inputs.uniform_limbs(g, bls.R, self.blobs * self.n,
                                    self.device)

    def inputs(self, i: int):
        """Operation i's blobs: (blobs, 32 n) uint8 in host memory, each
        value 32 big-endian bytes."""
        v = self._values(i).cpu().numpy().view(np.uint32)    # (8, blobs n)
        be = np.ascontiguousarray(v.T[:, ::-1]).astype(">u4")
        return torch.from_numpy(be.view(np.uint8).reshape(self.blobs, -1))

    def run(self, blobs, tracer):
        rec = self.profiling.recording() if tracer is not None \
            else contextlib.nullcontext()
        with rec:
            cms, proofs = self.port.prove_blobs(self.setup_, blobs)
        return torch.cat([cms, proofs]).cpu()

    def units(self, blobs) -> float:
        """MSM points: a commitment and a proof of n points per blob."""
        return float(2 * self.n * blobs.shape[0])

    def keep(self, i: int, blobs, out) -> None:
        """Reservoir sampling: after t operations each is held with
        probability sample / t."""
        self.count += 1
        if len(self.kept) < self.sample:
            self.kept.append((i, out.clone()))
        else:
            slot = int(self.pick.integers(self.count))
            if slot < self.sample:
                self.kept[slot] = (i, out.clone())

    # -- judgement ----------------------------------------------------------------
    def _blob_bytes(self, i: int) -> List[bytes]:
        data = bytes(self.inputs(i).numpy())
        step = len(data) // self.blobs
        return [data[j * step:(j + 1) * step] for j in range(self.blobs)]

    def _reference(self, i: int, bit_reversed: bool) -> List[bytes]:
        """The commitments, then the proofs, of operation i's blobs."""
        pr = eip4844.Prover(self.tau, self.n, bit_reversed, self.fb)
        both = [pr.prove(b) for b in self._blob_bytes(i)]
        return [c for c, _ in both] + [p for _, p in both]

    def answers(self) -> List[tuple]:
        return [(i, [bytes(row) for row in out.numpy()])
                for i, out in self.kept]

    @functools.cached_property
    def fb(self) -> bls.FixedBase:
        return bls.FixedBase()

    def control_answers(self) -> List[tuple]:
        return [(i, self._reference(i, bit_reversed=False))
                for i, _ in self.kept]

    def compare(self, answers) -> List[dict]:
        wrong = 0
        for i, got in answers:
            want = self._reference(i, bit_reversed=True)
            wrong += sum(g != w for g, w in zip(got, want))
            wrong += abs(len(got) - len(want))
        return [dict(name="wrong_blob_results", value=wrong, limit=0)]
