"""The port's EIP-4844 blob prover (protocols/eip4844.py) and the ZCash
48-byte G1 encoding (ops/curve.py) against the plain reference
`zkbench/eip4844.py`, the consensus-specs functions on Python ints.

Blobs of 16 and 64 elements, drawn from a seed, over a setup of a known
tau (its natural-order Lagrange points worked out on the host), byte for
byte; the MSM's window is fixed small, which only changes the CPU's time.
The JAX package has no blob prover, so the reference is the spec's.  On
the CPU every product runs the plain version of kernel K1.
"""

import random

import pytest
import torch

from zkbench import bls, eip4844 as ref
from zikkurat_algebra_tpu_torch import api
from zikkurat_algebra_tpu_torch.protocols import eip4844
from zikkurat_algebra_tpu_torch.utils import profiling

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

TAU = 0x2DFBC9B729A030FB654DF172264E7037EEDC666567871AC49F9042FCCEF164E9
WINDOW = {16: 4, 64: 5}


@pytest.fixture(scope="module")
def fixed_base():
    return bls.FixedBase()


def make_setup(n, fixed_base):
    pts = fixed_base.mul_many(bls.lagrange_at(TAU, n))
    return eip4844.load_setup(pts, device="cpu", window_bits=WINDOW[n])


def rand_blob(rng, n):
    return ref.polynomial_to_blob([rng.randrange(bls.R) for _ in range(n)])


def test_setup_is_bit_reversed_once(fixed_base):
    """The spec's roots w = 7^((r - 1) / n) and its bit-reversal
    permutation of the points and the roots, made at load."""
    n = 16
    pts = fixed_base.mul_many(bls.lagrange_at(TAU, n))
    setup = eip4844.load_setup(pts, device="cpu")
    ck = setup.curves
    assert setup.n == n and setup.window_bits is None
    assert setup.roots == tuple(bls.domain(n))
    assert ck.fr.decode(setup.roots_brp) == list(ref.roots_of_unity(n))
    assert ck.decode_g1(setup.lagrange_brp) == \
        ref.bit_reversal_permutation(pts)
    assert setup.index_brp[ref.roots_of_unity(n)[3]] == 3
    assert eip4844.bit_reversal_indices(8) == [0, 4, 2, 6, 1, 5, 3, 7]
    # the same from the points already on the device
    again = eip4844.load_setup(ck.encode_g1(pts), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.lagrange_brp,
                                                 setup.lagrange_brp))


@pytest.mark.parametrize("n, seed, B", [pytest.param(16, 1, 3, id="16-1"),
                                         pytest.param(64, 2, 1, id="64-2")])
def test_commitment_and_proof_bytes(fixed_base, n, seed, B):
    """prove_blobs (blob_to_kzg_commitments, compute_blob_kzg_proofs) of
    B blobs gives the reference's commitments and blob proofs byte for
    byte in one msm_std for the commitments and one for the proofs, each
    over the B scalar vectors, and counts the blobs under recording."""
    rng = random.Random(seed)
    setup = make_setup(n, fixed_base)
    blobs = [rand_blob(rng, n) for _ in range(B)]
    profiling.reset()
    with profiling.recording():
        cms, proofs = eip4844.prove_blobs(setup, blobs)
    assert profiling.counts() == {"blobs": B, "blob_z_in_domain": 0,
                                  "msm_scalar_sets": 2 * B}
    spans = profiling.totals()
    assert all(spans[s]["calls"] == 1 for s in (
        "kzg.blob_prove", "kzg.blob_commit", "kzg.blob_challenge",
        "kzg.blob_open"))
    assert spans["msm.std"]["calls"] == 2
    profiling.reset()
    prover = ref.Prover(TAU, n, fixed_base=fixed_base)
    assert cms.shape == proofs.shape == (B, 48)
    assert [(bytes(c.numpy()), bytes(p.numpy()))
            for c, p in zip(cms, proofs)] == [prover.prove(b) for b in blobs]


def test_kzg_proof_within_domain(fixed_base):
    """compute_kzg_proof at a z forced onto a root: y is the blob's own
    value there and the quotient takes compute_quotient_eval_within_domain
    at that root; the proof bytes and y equal the reference's."""
    n = 16
    setup = make_setup(n, fixed_base)
    blob = rand_blob(random.Random(3), n)
    poly = ref.blob_to_polynomial(blob, n)
    z = ref.roots_of_unity(n)[5]
    profiling.reset()
    with profiling.recording():
        proof, y = eip4844.compute_kzg_proof(setup, blob, z.to_bytes(32, "big"))
    assert profiling.counts() == {"blob_z_in_domain": 1,
                                  "msm_scalar_sets": 1}
    profiling.reset()
    want, want_y = ref.Prover(TAU, n, fixed_base=fixed_base).kzg_proof(poly, z)
    assert int.from_bytes(y, "big") == want_y == poly[5]
    assert bytes(proof.numpy()) == want
    # the proof is of the quotient (p - y) / (x - z): its scalar at tau
    q, _ = ref.compute_kzg_proof_impl(poly, z)
    c = ref.lincomb_scalar(poly, TAU)
    assert ref.lincomb_scalar(q, TAU) == (c - want_y) * pow(TAU - z, -1,
                                                            bls.R) % bls.R


def test_non_canonical_element_raises(fixed_base):
    n = 16
    setup = make_setup(n, fixed_base)
    vals = [random.Random(4).randrange(bls.R) for _ in range(n)]
    good = ref.polynomial_to_blob(vals)
    assert eip4844.blobs_to_fields(setup, good).shape == (8, 1, n)
    for bad_value in (bls.R, (1 << 256) - 1):
        vals[7] = bad_value
        bad = ref.polynomial_to_blob(vals)
        with pytest.raises(ValueError, match="not below"):
            ref.blob_to_polynomial(bad, n)
        with pytest.raises(ValueError, match="not below"):
            eip4844.blobs_to_fields(setup, [good, bad])
        with pytest.raises(ValueError, match="not below"):
            eip4844.blob_to_kzg_commitments(setup, bad)
    with pytest.raises(ValueError, match="not below"):
        eip4844.compute_kzg_proof(setup, good, bls.R.to_bytes(32, "big"))
    with pytest.raises(ValueError, match="commitment bytes for 2 blobs"):
        eip4844.compute_blob_kzg_proofs(setup, [good, good],
                                        ref.g1_to_bytes48(None))
    with pytest.raises(ValueError):
        eip4844.blob_to_kzg_commitments(setup, good[:-1])


def test_bytes48_round_trip_and_flags(fixed_base):
    """g1_to_bytes48 equals the reference's encoding (infinity included),
    the sign flag 0x20 marks the larger of y and p - y, and
    g1_from_bytes48 gives the points back; malformed encodings are
    invalid."""
    a = api.bls12_381("cpu")
    pts = [None, bls.G1_GEN, bls.g1_neg(bls.G1_GEN)] + fixed_base.mul_many(
        [random.Random(6).randrange(bls.R) for _ in range(3)])
    enc = a.g1_to_bytes48(a.encode_g1(pts))
    assert enc.shape == (len(pts), 48) and enc.dtype == torch.uint8
    got = [bytes(e.numpy()) for e in enc]
    assert got == [ref.g1_to_bytes48(p) for p in pts]
    assert got[0] == bytes([0xC0]) + bytes(47)
    for pt, e in zip(pts[1:], got[1:]):
        assert e[0] & 0x80 and not e[0] & 0x40
        assert bool(e[0] & 0x20) == (pt[1] > (bls.P - 1) // 2)
    assert (got[1][0] ^ got[2][0]) == 0x20 and got[1][1:] == got[2][1:]

    x_not_on_curve = next(x for x in range(1, 50) if pow(
        x ** 3 + 4, (bls.P - 1) // 2, bls.P) != 1)
    bad = [bytes(48),                                   # no compressed flag
           bytes([0xC0]) + bytes(46) + b"\x01",         # infinity, x != 0
           bytes([0xE0]) + bytes(47),                   # infinity, sign set
           bytes([0x80]) + bytes(47),                   # x = 0, no inf flag
           (bls.P | 1 << 383).to_bytes(48, "big"),      # x = p
           (x_not_on_curve | 1 << 383).to_bytes(48, "big")]
    data = torch.stack([torch.frombuffer(bytearray(b), dtype=torch.uint8)
                        for b in got + bad])
    aff, valid = a.g1_from_bytes48(data)
    assert valid.tolist() == [True] * len(got) + [False] * len(bad)
    assert a.decode_g1(tuple(t[..., :len(pts)] for t in aff)) == pts
    assert a.decode_g1(tuple(t[..., len(pts):] for t in aff)) == \
        [None] * len(bad)


def test_challenge_matches_reference():
    rng = random.Random(7)
    for n in (16, 4096):
        blob = rand_blob(rng, n)
        cm = bytes(rng.randrange(256) for _ in range(48))
        assert eip4844.compute_challenge(blob, cm, n) == \
            ref.compute_challenge(blob, cm, n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


@pytest.mark.gpu
def test_blobs_on_the_card(card, fixed_base):
    """On the card (K1, K2, K3, the point kernels): three blobs of 64
    elements proven as a batch in two msm_std calls (K2 and K3 twice),
    and a proof at a root, byte for byte; the 48-byte encoding of the
    commitments read back."""
    n = 64
    pts = fixed_base.mul_many(bls.lagrange_at(TAU, n))
    setup = eip4844.load_setup(pts, device="cuda")
    rng = random.Random(8)
    blobs = [rand_blob(rng, n) for _ in range(3)]
    profiling.reset()
    with profiling.recording():
        cms, proofs = eip4844.prove_blobs(setup, blobs)
    launches = profiling.totals()["kzg.blob_prove"]["launches"]
    assert profiling.totals()["msm.std"]["calls"] == 2
    assert profiling.counts()["msm_scalar_sets"] == 6
    assert launches["bucket_scan"] == launches["sort_key_val"] == 2
    profiling.reset()
    prover = ref.Prover(TAU, n, fixed_base=fixed_base)
    assert [(bytes(c.cpu().numpy()), bytes(p.cpu().numpy()))
            for c, p in zip(cms, proofs)] == [prover.prove(b) for b in blobs]
    z = ref.roots_of_unity(n)[9]
    proof, y = eip4844.compute_kzg_proof(setup, blobs[0], z.to_bytes(32, "big"))
    poly = ref.blob_to_polynomial(blobs[0], n)
    assert (bytes(proof.cpu().numpy()), int.from_bytes(y, "big")) == \
        prover.kzg_proof(poly, z)
    aff, valid = setup.curves.g1_from_bytes48(cms)
    assert bool(valid.all())
    assert [ref.g1_to_bytes48(p) for p in setup.curves.decode_g1(aff)] == \
        [bytes(c.cpu().numpy()) for c in cms]
