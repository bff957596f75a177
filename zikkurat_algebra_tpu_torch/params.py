"""Field, tower and curve constants for the curve families the port supports.

The port keeps its own copy of the values it needs: the prime p, the
scalar field order r, the curve coefficient b (a = 0 for all three
families), the G1 generator and cofactor, the quadratic extension
Fp2 = Fp[u] / (u^2 - qnr) with the Fp6 nonresidue xi, and the G2 twist
y^2 = x^3 + b2 over Fp2 with its generator and cofactor.  The scalar fields
carry their largest power-of-two FFT domain (two-adicity and generator),
every field a quadratic non-residue, and G1 its GLV endomorphism.
The values are the published constants of BN128 (alt-bn128 / BN254),
BLS12-381 and BLS12-377.  BLS12-377 has its tower (u^2 = -5) but no G2 (b2 = None).
`TEST_PRIMES` (primes at the limb boundaries) and `CURVE_DB` (the base
and scalar primes of twelve standard curves) give fields only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

Fp2Int = Tuple[int, int]


@dataclass(frozen=True)
class FieldParams:
    """A prime field GF(p).  `multiplicative_gen` is a quadratic
    non-residue (it seeds Tonelli-Shanks; for the curve fields it is the
    smallest generator of the multiplicative group); `fft_domain` =
    (two-adicity k, generator of the 2^k-th roots of unity) for the
    fields that have NTT domains."""

    name: str
    p: int
    multiplicative_gen: int
    fft_domain: Optional[Tuple[int, int]] = None


@dataclass(frozen=True)
class TowerParams:
    """Fp2 = Fp[u] / (u^2 - qnr); xi = xi0 + xi1 u is the Fp6 nonresidue."""

    xi0: int
    xi1: int
    qnr: int = -1


@dataclass(frozen=True)
class CurveParams:
    """A short-Weierstrass curve y^2 = x^3 + a x + b over Fp (G1) and its
    twist y^2 = x^3 + b2 over Fp2 (G2; b2 = None where there is none).
    `glv_beta_lambda` = (beta, lambda): beta a cube root of unity in Fp
    and lambda one in Fr such that (beta x, y) = [lambda] (x, y) or
    [lambda^2] (x, y) on G1 (which of the two `CurveKernels` finds out).
    `seed` is the curve's parameter x and `family` "bn" or "bls"; the
    optimal-Ate Miller loop runs over `ate_loop_count` (params.py:130-143
    of the JAX package)."""

    name: str
    fp: FieldParams
    fr: FieldParams
    a: int
    b: int
    cofactor: int
    g1_gen: Tuple[int, int]
    tower: TowerParams
    glv_beta_lambda: Optional[Tuple[int, int]] = None
    b2: Optional[Fp2Int] = None
    g2_cofactor: Optional[int] = None
    g2_gen: Optional[Tuple[Fp2Int, Fp2Int]] = None
    seed: int = 0
    family: str = "bls"

    @property
    def ate_loop_count(self) -> int:
        """|Miller loop scalar|: 6 x + 2 for BN, |x| for BLS."""
        if self.family == "bn":
            return 6 * self.seed + 2
        return abs(self.seed)


BN128_FP = FieldParams(
    "BN128/Fp",
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
    3,
)
BN128_FR = FieldParams(
    "BN128/Fr",
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
    5,
    fft_domain=(
        28,
        19103219067921713944291392827692070036145651957329286315305642004821462161904,
    ),
)
BN128 = CurveParams(
    name="BN128", fp=BN128_FP, fr=BN128_FR, a=0, b=3, cofactor=1,
    g1_gen=(1, 2),
    tower=TowerParams(xi0=9, xi1=1),                # v^3 = 9 + u
    glv_beta_lambda=(
        2203960485148121921418603742825762020974279258880205651966,
        4407920970296243842393367215006156084916469457145843978461,
    ),
    b2=(
        19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690,
    ),
    g2_cofactor=21888242871839275222246405745257275088844257914179612981679871602714643921549,
    g2_gen=(
        (
            0x1ADCD0ED10DF9CB87040F46655E3808F98AA68A570ACF5B0BDE23FAB1F149701,
            0x09E847E9F05A6082C3CD2A1D0A3A82E6FBFBE620F7F31269FA15D21C1C13B23B,
        ),
        (
            0x056C01168A5319461F7CA7AA19D4FCFD1C7CDF52DBFC4CBEE6F915250B7F6FC8,
            0x0EFE500A2D02DD77F5F401329F30895DF553B878FC3C0DADAAA86456A623235C,
        ),
    ),
    seed=4965661367192848881,
    family="bn",
)

BLS12_381_FP = FieldParams(
    "BLS12-381/Fp",
    4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787,
    2,
)
BLS12_381_FR = FieldParams(
    "BLS12-381/Fr",
    52435875175126190479447740508185965837690552500527637822603658699938581184513,
    7,
    fft_domain=(
        32,
        10238227357739495823651030575849232062558860180284477541189508159991286009131,
    ),
)
BLS12_381 = CurveParams(
    name="BLS12-381", fp=BLS12_381_FP, fr=BLS12_381_FR, a=0, b=4,
    cofactor=76329603384216526031706109802092473003,
    g1_gen=(
        3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
        1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    ),
    tower=TowerParams(xi0=1, xi1=1),                # v^3 = 1 + u
    glv_beta_lambda=(
        4002409555221667392624310435006688643935503118305586438271171395842971157480381377015405980053539358417135540939436,
        228988810152649578064853576960394133503,
    ),
    b2=(4, 4),                                      # 4 (1 + u)
    g2_cofactor=305502333931268344200999753193121504214466019254188142667664032982267604182971884026507427359259977847832272839041616661285803823378372096355777062779109,
    g2_gen=(
        (
            352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
            3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758,
        ),
        (
            1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
            927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582,
        ),
    ),
    seed=-0xD201000000010000,
    family="bls",
)

BLS12_377_FP = FieldParams(
    "BLS12-377/Fp",
    0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    5,
)
BLS12_377_FR = FieldParams(
    "BLS12-377/Fr",
    0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    11,
    fft_domain=(                    # 11^((r - 1) / 2^47)
        47,
        6924886788847882060123066508223519077232160750698452411071850219367055984476,
    ),
)
BLS12_377 = CurveParams(
    name="BLS12-377", fp=BLS12_377_FP, fr=BLS12_377_FR, a=0, b=1,
    cofactor=0x170B5D44300000000000000000000000,
    g1_gen=(
        81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
        241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
    ),
    tower=TowerParams(xi0=0, xi1=1, qnr=-5),        # u^2 = -5, v^3 = u
    glv_beta_lambda=(
        80949648264912719408558363140637477264845294720710499478137287262712535938301461879813459410945,
        0x452217CC900000010A11800000000000,        # z^2 - 1 mod r
    ),
    seed=0x8508C00000000001,
    family="bls",
)

CURVES = {"BN128": BN128, "BLS12-381": BLS12_381, "BLS12-377": BLS12_377}
FIELDS = {f.name: f for c in CURVES.values() for f in (c.fp, c.fr)}

# Primes near powers of two that stress the limb arithmetic: one to four
# 32-bit limbs (M31 one; P45-, P45+, P60-, M61 and goldilocks two; P64+
# three; M127 four), Mersenne primes (all-ones limbs), primes just above
# a power of two whose top limb is 1 (P45+, P64+), primes above half the
# Montgomery R (goldilocks, R = 2^64; P255+, R = 2^256) and both classes
# of p mod 4 (p = 1 mod 4 takes Tonelli-Shanks: goldilocks at
# two-adicity 32).  `multiplicative_gen` is a quadratic non-residue.
TEST_PRIMES = {
    "M31": FieldParams("test/2^31-1", 2**31 - 1, 3),
    "P45-": FieldParams("test/2^45-55", 2**45 - 55, 5),
    "P45+": FieldParams("test/2^45+59", 2**45 + 59, 2),
    "P60-": FieldParams("test/2^60-93", 2**60 - 93, 2),
    "M61": FieldParams("test/2^61-1", 2**61 - 1, 3),
    "goldilocks": FieldParams(
        "test/goldilocks", 2**64 - 2**32 + 1, 7,
        fft_domain=(32, pow(7, (2**64 - 2**32) >> 32, 2**64 - 2**32 + 1)),
    ),
    "P64+": FieldParams("test/2^64+13", 2**64 + 13, 2),
    "M127": FieldParams("test/2^127-1", 2**127 - 1, 3),
    "P255-19": FieldParams("test/2^255-19", 2**255 - 19, 2),
    "P255+": FieldParams("test/2^255+95", 2**255 + 95, 3),
}

# (base field prime, scalar field prime) of standard curves.  The scalar
# fields of the cofactor curves (JubJub, Bandersnatch, BabyJubJub,
# Curve25519) are their prime subgroup orders.  Any entry gives a `Field`.
CURVE_DB = {
    "BN254": (BN128_FP.p, BN128_FR.p),
    "BLS12-381": (BLS12_381_FP.p, BLS12_381_FR.p),
    "BLS12-377": (BLS12_377_FP.p, BLS12_377_FR.p),
    "JubJub": (
        BLS12_381_FR.p,
        0xE7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7,
    ),
    "Bandersnatch": (
        BLS12_381_FR.p,
        0x1CFB69D4CA675F520CCE760202687600FF8F87007419047174FD06B52876E7E1,
    ),
    "BabyJubJub": (
        BN128_FR.p,
        2736030358979909402780800718157159386076813972158567259200215660948447373041,
    ),
    "Pallas": (
        0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
        0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
    ),
    "Secp256k1": (
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    ),
    "Curve25519": (
        2**255 - 19,
        7237005577332262213973186563042994240857116359379907606001950938285454250989,
    ),
}
# the partners with the two fields swapped
CURVE_DB["Vesta"] = (CURVE_DB["Pallas"][1], CURVE_DB["Pallas"][0])
CURVE_DB["Grumpkin"] = (CURVE_DB["BN254"][1], CURVE_DB["BN254"][0])
CURVE_DB["Secq256k1"] = (CURVE_DB["Secp256k1"][1], CURVE_DB["Secp256k1"][0])


def smallest_nonresidue(p: int) -> int:
    """The smallest quadratic non-residue mod the odd prime p."""
    g = 2
    while pow(g, (p - 1) // 2, p) == 1:
        g += 1
    return g


def curve_db_field(curve: str, which: str = "scalar") -> FieldParams:
    """The base ("base") or scalar ("scalar") field of a `CURVE_DB` curve,
    with its smallest non-residue as `multiplicative_gen`."""
    if which not in ("base", "scalar"):
        raise ValueError(f"which={which!r}: use 'base' or 'scalar'")
    base_p, scalar_p = CURVE_DB[curve]
    p = scalar_p if which == "scalar" else base_p
    return FieldParams(f"{curve}/{'Fr' if which == 'scalar' else 'Fp'}", p,
                       smallest_nonresidue(p))


def sage_setup(curve: CurveParams) -> str:
    """A Sage script that checks a curve's G1 constants: the generator's
    order, the group order r h and, where set, the GLV beta and lambda."""
    lines = [
        f"# {curve.name} elliptic curve",
        f"p  = {curve.fp.p}",
        f"r  = {curve.fr.p}",
        f"h  = {curve.cofactor}",
        "Fp = GF(p)",
        "Fr = GF(r)",
        f"A  = Fp({curve.a})",
        f"B  = Fp({curve.b})",
        "E  = EllipticCurve(Fp,[A,B])",
        f"gx = Fp({curve.g1_gen[0]})",
        f"gy = Fp({curve.g1_gen[1]})",
        "gen = E(gx,gy)  # subgroup generator",
        'print("scalar field check: ", gen.additive_order() == r )',
        'print("cofactor check:     ", E.cardinality() == r*h )',
    ]
    if curve.glv_beta_lambda is not None:
        beta, lam = curve.glv_beta_lambda
        lines += [
            "",
            "# GLV beta and lambda parameters",
            f"beta = Fp({beta})",
            f"lam  = {lam}",
            "pt   = 1234567 * gen;",
            "pt2  = E( beta*pt[0] , pt[1], pt[2] )",
            'print("beta check:   ", beta^3 == 1 )',
            'print("lambda check: ", Fr(lam)^3 == 1 )',
            'print("GLV check:    ", lam * pt == pt2 )',
        ]
    return "\n".join(lines)
