"""The EIP-4844 blob prover on the port's kernels, batched over B blobs.

The prover functions of consensus-specs `specs/deneb/polynomial-
commitments.md`.  A blob is n (the spec's FIELD_ELEMENTS_PER_BLOB, 4096)
elements of Fr, each 32 big-endian bytes below r; element i is the
polynomial's value at w^brp(i), w = 7^((r - 1) / n) and brp the
bit-reversal permutation.  Commitments and proofs are ZCash-compressed
G1 points, 48 bytes (`CurveKernels.g1_to_bytes48`), as (B, 48) uint8
tensors on the setup's device.

- `load_setup`: the natural-order Lagrange points [L_i(tau)] G1 (a
  node's `trusted_setup.txt`), bit-reversed once here, with the roots.
- `blob_to_kzg_commitments`: ONE G1 `msm_std` (K3, K2, the point
  kernels) for the batch over those points, its rows the (blob, window)
  pairs, the scalars (W, B, n); ONE `to_affine`.
- `compute_blob_kzg_proofs`: the commitments validated as the spec's
  `bytes_to_kzg_commitment` does (decompression and the subgroup test
  on the device, one wait to read them back); the challenges on the
  host (SHA-256, `compute_challenge`); then for every blob y = p(z) by
  the barycentric formula and the quotient (p_i - y) / (w_i - z), both
  from ONE `batch_inv` of the B n differences z - w_i, q at w_i = z by
  `compute_quotient_eval_within_domain`; ONE batched MSM of the B
  quotients, ONE `to_affine`.
- `compute_kzg_proof`: the same opening at a given z.
- `prove_blobs`: commitments, then proofs, of a batch.

Spans (`utils.profiling`): `kzg.blob_prove` holds `kzg.blob_commit`,
`kzg.blob_challenge` and `kzg.blob_open`; counters `blobs` (blob proofs)
and `blob_z_in_domain`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import params as P
from ..errors import DomainSizeError
from ..oracle.ntt import subgroup_gen
from ..ops import limbs as lb, vector as V
from ..ops.curve import AffBatch, CurveKernels, Point, get_curves
from ..utils import profiling as prof

BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_COMMITMENT = 48
FIELD_ELEMENTS_PER_BLOB = 4096
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"

Blobs = Union[torch.Tensor, bytes, Sequence[bytes]]


def bit_reversal_indices(n: int) -> List[int]:
    """brp(i) for i < n, n a power of two: i with its log2(n) bits
    reversed."""
    if n < 1 or n & (n - 1):
        raise DomainSizeError(f"{n} is not a power of two")
    k = n.bit_length() - 1
    return [int(format(i, f"0{k}b")[::-1], 2) if k else 0 for i in range(n)]


@dataclass
class BlobSetup:
    curves: CurveKernels
    n: int                          # field elements per blob
    lagrange_brp: AffBatch          # [L_brp(i)(tau)] G1, i < n
    roots: Tuple[int, ...]          # w^i, natural order (host)
    roots_brp: torch.Tensor         # (W, n) Montgomery w^brp(i)
    index_brp: Dict[int, int]       # w^brp(i) -> i (host)
    window_bits: Optional[int] = None   # the MSM's; None: its own choice

    @property
    def device(self) -> torch.device:
        return self.roots_brp.device

    @property
    def blob_bytes(self) -> int:
        return BYTES_PER_FIELD_ELEMENT * self.n


def load_setup(lagrange_g1, curve: P.CurveParams = P.BLS12_381,
               device="cuda", window_bits: Optional[int] = None
               ) -> BlobSetup:
    """The setup of the natural-order Lagrange points [L_i(tau)] G1,
    i < n (the spec's KZG_SETUP_G1_LAGRANGE): affine int pairs (None for
    infinity), or an affine batch (x, y, inf).  The points and the roots
    are bit-reversed here, once."""
    ck = get_curves(curve, device)
    if isinstance(lagrange_g1, tuple) and isinstance(lagrange_g1[0],
                                                     torch.Tensor):
        A = tuple(t.to(ck.device) for t in lagrange_g1)
    else:
        A = ck.encode_g1(list(lagrange_g1))
    n = A[0].shape[-1]
    brp = bit_reversal_indices(n)
    perm = torch.tensor(brp, device=ck.device)
    w = subgroup_gen(curve.fr, n.bit_length() - 1)
    roots, acc = [], 1
    for _ in range(n):
        roots.append(acc)
        acc = acc * w % curve.fr.p
    roots_brp = [roots[j] for j in brp]
    return BlobSetup(
        curves=ck, n=n,
        lagrange_brp=tuple(t[..., perm].contiguous() for t in A),
        roots=tuple(roots), roots_brp=ck.fr.encode(roots_brp),
        index_brp={v: i for i, v in enumerate(roots_brp)},
        window_bits=window_bits)


# -- bytes ---------------------------------------------------------------------

def _blob_tensor(setup: BlobSetup, blobs: Blobs) -> torch.Tensor:
    """Blobs as a (B, n 32) uint8 tensor, where they are (a tensor stays
    on its device; bytes go to the host's memory)."""
    if isinstance(blobs, (bytes, bytearray, memoryview)):
        blobs = [blobs]
    if not isinstance(blobs, torch.Tensor):
        blobs = torch.stack([torch.frombuffer(bytearray(b), dtype=torch.uint8)
                             for b in blobs])
    if blobs.dtype != torch.uint8 or blobs.ndim != 2 \
            or blobs.shape[1] != setup.blob_bytes:
        raise ValueError(f"blobs of shape {tuple(blobs.shape)} "
                         f"({blobs.dtype}), not (B, {setup.blob_bytes}) uint8")
    return blobs


def _blob_limbs(setup: BlobSetup, blobs: torch.Tensor) -> torch.Tensor:
    """(B, n 32) uint8 -> standard-form limbs (W, B, n) on the setup's
    device; an element not below r raises (`bytes_to_bls_field`), checked
    where the bytes are."""
    fr = setup.curves.fr
    x = lb.be_bytes_to_limbs(blobs.reshape(blobs.shape[0], setup.n,
                                           BYTES_PER_FIELD_ELEMENT), fr.W)
    if not bool(lb.below(x, fr.p).all()):
        raise ValueError("a blob element is not below the modulus r")
    return x.to(setup.device)


def blobs_to_fields(setup: BlobSetup, blobs: Blobs) -> torch.Tensor:
    """The spec's blob_to_polynomial of each blob: (W, B, n) Montgomery
    Fr on the setup's device."""
    return setup.curves.fr.to_mont(_blob_limbs(setup,
                                               _blob_tensor(setup, blobs)))


def _bytes48(cms) -> torch.Tensor:
    if isinstance(cms, torch.Tensor):
        return cms
    if isinstance(cms, (bytes, bytearray, memoryview)):
        cms = [cms]
    return torch.stack([torch.frombuffer(bytearray(c), dtype=torch.uint8)
                        for c in cms])


def compute_challenge(blob, commitment, n: int = FIELD_ELEMENTS_PER_BLOB
                      ) -> int:
    """SHA-256 of the domain tag, n as 16 big-endian bytes, the blob and
    the commitment (byte buffers), taken mod r."""
    h = hashlib.sha256(FIAT_SHAMIR_PROTOCOL_DOMAIN + n.to_bytes(16, "big"))
    h.update(blob)
    h.update(commitment)
    return int.from_bytes(h.digest(), "big") % P.BLS12_381.fr.p


# -- the MSMs --------------------------------------------------------------------

def _msm(setup: BlobSetup, k_std: torch.Tensor) -> Point:
    """g1_lincomb of the bit-reversed points and each blob's standard-form
    scalars (W, B, n), in one `msm_std`: a point of batch (B,)."""
    return setup.curves.msm("g1").msm_std(
        k_std, setup.lagrange_brp, setup.window_bits, min(512, setup.n))


def _to_bytes(setup: BlobSetup, points: Point) -> torch.Tensor:
    """A projective point of batch (B,) -> (B, 48) uint8 through one
    `to_affine`."""
    ck = setup.curves
    return ck.g1_to_bytes48(ck.g1.to_affine(points))


def blob_to_kzg_commitments(setup: BlobSetup, blobs: Blobs) -> torch.Tensor:
    """(B, 48) uint8: each blob's blob_to_kzg_commitment."""
    blobs = _blob_tensor(setup, blobs)
    with prof.span("kzg.blob_commit", setup.device):
        return _to_bytes(setup, _msm(setup, _blob_limbs(setup, blobs)))


# -- the opening ---------------------------------------------------------------------

@dataclass
class _Points:
    z: torch.Tensor                 # (W, B) Montgomery
    factor: torch.Tensor            # (W, B): (z^n - 1) / n
    within: List[Tuple[int, int]]   # (b, i) where z_b = w^brp(i)
    z_inv: Dict[int, torch.Tensor]  # b -> (W,) 1 / z_b, those b only


def _points(setup: BlobSetup, zs: Sequence[int]) -> _Points:
    """The evaluation points on the device, with what the host knows of
    them: which are roots, and their inverses."""
    fr, n = setup.curves.fr, setup.n
    r = fr.p
    n_inv = pow(n, -1, r)
    within = [(b, setup.index_brp[z]) for b, z in enumerate(zs)
              if z in setup.index_brp]
    inv = [pow(zs[b], -1, r) for b, _ in within]
    prof.count("blob_z_in_domain", len(within))
    B = len(zs)
    vals = fr.encode(list(zs) + [(pow(z, n, r) - 1) * n_inv for z in zs]
                     + inv)
    return _Points(z=vals[:, :B], factor=vals[:, B:2 * B], within=within,
                   z_inv={b: vals[:, 2 * B + j]
                          for j, (b, _) in enumerate(within)})


def _open(setup: BlobSetup, polys: torch.Tensor, pts: _Points
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """compute_kzg_proof_impl of each (W, B, n) blob polynomial at its
    point: ((B, 48) proofs, y (W, B))."""
    fr = setup.curves.fr
    W, B, n = polys.shape
    roots = setup.roots_brp.unsqueeze(1).expand(W, B, n)
    inv = fr.batch_inv(fr.sub(pts.z.unsqueeze(-1).expand(W, B, n), roots))
    # y = (z^n - 1) / n sum_i p_i w_i / (z - w_i); p_i itself at z = w_i
    s = V.sum_mod(fr, fr.mul(fr.mul(polys, roots), inv))
    y = fr.mul(pts.factor, s)
    for b, i in pts.within:
        y[:, b] = polys[:, b, i]
    # q_i = (p_i - y) / (w_i - z); 0 where w_i = z (inv is 0 there)
    q = fr.mul(fr.sub(y.unsqueeze(-1).expand(W, B, n), polys), inv)
    for b, i in pts.within:
        # q(z) = sum_{j != i} (p_j - y) w_j / (z (z - w_j)) = -sum_j q_j w_j / z
        t = V.sum_mod(fr, fr.mul(q[:, b], setup.roots_brp))
        q[:, b, i] = fr.neg(fr.mul(pts.z_inv[b], t))
    return _to_bytes(setup, _msm(setup, fr.from_mont(q))), y


def _validated(setup: BlobSetup, cms: torch.Tensor) -> np.ndarray:
    """The spec's bytes_to_kzg_commitment of each commitment: decompressed
    and tested for the subgroup on the device, read back with the bytes
    in one wait; raises where one is invalid.  (B, 48) uint8 on the host."""
    ck = setup.curves
    cms = cms.to(setup.device)
    aff, ok = ck.g1_from_bytes48(cms)
    ok = ok & ck.g1.is_in_subgroup(ck.g1.from_affine(aff))
    host = torch.cat([cms, ok.to(torch.uint8).unsqueeze(1)], 1).cpu().numpy()
    if not host[:, -1].all():
        raise ValueError("a commitment is not a valid G1 point of the "
                         "subgroup")
    return host[:, :-1]


def compute_blob_kzg_proofs(setup: BlobSetup, blobs: Blobs, commitments
                            ) -> torch.Tensor:
    """(B, 48) uint8: each blob's compute_blob_kzg_proof against its
    commitment ((B, 48) uint8 on any device, or 48-byte buffers)."""
    blobs = _blob_tensor(setup, blobs)
    cms = _bytes48(commitments)
    B = blobs.shape[0]
    if tuple(cms.shape) != (B, BYTES_PER_COMMITMENT):
        raise ValueError(f"{tuple(cms.shape)} commitment bytes for {B} blobs")
    with prof.span("kzg.blob_challenge", setup.device):
        cm_host = _validated(setup, cms)
        polys = blobs_to_fields(setup, blobs)
        host = blobs.cpu().numpy()
        pts = _points(setup, [compute_challenge(host[b], cm_host[b], setup.n)
                              for b in range(B)])
    with prof.span("kzg.blob_open", setup.device):
        proofs, _ = _open(setup, polys, pts)
    prof.count("blobs", B)
    return proofs


def compute_kzg_proof(setup: BlobSetup, blob: Blobs, z_bytes: bytes
                      ) -> Tuple[torch.Tensor, bytes]:
    """The spec's compute_kzg_proof: (the (48,) uint8 proof, y = p(z) as 32
    big-endian bytes) for one blob and z given as 32 big-endian bytes
    below r."""
    if len(z_bytes) != BYTES_PER_FIELD_ELEMENT:
        raise ValueError(f"z of {len(z_bytes)} bytes, not 32")
    z = int.from_bytes(z_bytes, "big")
    fr = setup.curves.fr
    if z >= fr.p:
        raise ValueError("z is not below the modulus r")
    blob = _blob_tensor(setup, blob)
    if blob.shape[0] != 1:
        raise ValueError(f"{blob.shape[0]} blobs, not 1")
    proofs, y = _open(setup, blobs_to_fields(setup, blob), _points(setup, [z]))
    return proofs[0], fr.decode(y[:, 0]).to_bytes(BYTES_PER_FIELD_ELEMENT,
                                                  "big")


def prove_blobs(setup: BlobSetup, blobs: Blobs
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(commitments, proofs) of a batch, (B, 48) uint8 each:
    blob_to_kzg_commitments, then compute_blob_kzg_proofs."""
    blobs = _blob_tensor(setup, blobs)
    with prof.span("kzg.blob_prove", setup.device):
        cms = blob_to_kzg_commitments(setup, blobs)
        return cms, compute_blob_kzg_proofs(setup, blobs, cms)
