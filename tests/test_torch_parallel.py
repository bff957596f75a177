"""The port's sharded layer (zikkurat_algebra_tpu_torch.parallel) in
worlds of 2 and 4 gloo processes on the CPU.

Each test spawns one world (`torch.multiprocessing`, a `file://` store in
the test's tmp_path, never a TCP port) that runs every check of the
sharded functions inside it and reports each by name:

- `sharded_sum`, `sharded_dot`, `ShardedNTT` (ntt, intt and the round
  trip) and `ShardedPolyOps` (`mul`, `eval_at`, `div_by_vanishing` with
  n_van = 2 and 8) against the single-device JAX functions
  (`NTTDomain`, `get_poly_ops`, `vector.sum_mod` / `dot_prod`), computed
  in the test's own process and passed in as integers;
- `sharded_msm` on BN128 G1 (4 points per rank) against the port's
  oracle, and `ShardedGroupFFT` on 4 points (world of 2) against the
  oracle's group FFT and its own inverse: no JAX MSM is compiled;
- the typed errors: MeshError for a mesh of 3 ranks, DomainSizeError for
  a domain too small for the mesh.

No JAX `shard_map` function is called: a domain cached under it poisons
later JAX NTT tests in the same worker.  The module imports JAX only
inside the tests, so the spawned ranks, which import this module to find
their entry function, never load it.
"""

import json
import random
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.errors import DomainSizeError, MeshError
from zikkurat_algebra_tpu_torch.ops.curve import get_curves
from zikkurat_algebra_tpu_torch.ops.field import get_field
from zikkurat_algebra_tpu_torch.oracle.ntt import subgroup_gen
from zikkurat_algebra_tpu_torch.parallel.gfft import ShardedGroupFFT
from zikkurat_algebra_tpu_torch.parallel.mesh import (
    gather_batch, init_multihost, make_mesh, replicated, shard_batch)
from zikkurat_algebra_tpu_torch.parallel.msm import sharded_msm
from zikkurat_algebra_tpu_torch.parallel.ntt import ShardedNTT
from zikkurat_algebra_tpu_torch.parallel.poly import ShardedPolyOps
from zikkurat_algebra_tpu_torch.parallel.vector import sharded_dot, sharded_sum
from zikkurat_algebra_tpu_torch.utils.convert import shard_numpy

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

LOG_N = 5                   # the NTT and polynomial size, 2^5
N_VAN = (2, 8)
WORLD_SECONDS = 300         # a world that has not ended by then failed


def make_inputs(seed):
    """The test's integers (BN128 Fr values below r) from a numpy seed."""
    rng = np.random.default_rng(seed)
    r = P.BN128_FR.p
    n = 1 << LOG_N

    def ints(k):
        return [int.from_bytes(rng.bytes(40), "little") % r for _ in range(k)]

    return dict(a=ints(n), b=ints(n), half_a=ints(n // 2), half_b=ints(n // 2),
                x=ints(1)[0], eta=ints(1)[0], seed=int(rng.integers(1 << 62)))


def jax_expected(spec):
    """The single-device JAX results on the same integers."""
    from zikkurat_algebra_tpu import params as JP
    from zikkurat_algebra_tpu.ops import vector as JV
    from zikkurat_algebra_tpu.ops.field import get_field as jax_field
    from zikkurat_algebra_tpu.ops.ntt import NTTDomain as JaxNTTDomain
    from zikkurat_algebra_tpu.ops.poly import get_poly_ops as jax_poly

    jf = jax_field(JP.BN128_FR)
    dom = JaxNTTDomain(jf, LOG_N)
    jp = jax_poly(jf)
    a, b = jf.encode(spec["a"]), jf.encode(spec["b"])
    out = dict(sum=jf.decode(JV.sum_mod(jf, a)),
               dot=jf.decode(JV.dot_prod(jf, a, b)),
               ntt=jf.decode(dom.ntt(a)), intt=jf.decode(dom.intt(a)),
               mul=jf.decode(jp.mul(jf.encode(spec["half_a"]),
                                    jf.encode(spec["half_b"]))),
               eval_at=jf.decode(jp.eval_at(jf.encode(spec["x"]), a)))
    for nv in N_VAN:
        q, rem = jp.div_by_vanishing(a, nv, jf.encode(spec["eta"]))
        out[f"div{nv}"] = (jf.decode(q), jf.decode(rem))
    return out


def checks(size, spec, want):
    """Every check of one world, run on every rank; {name: passed}."""
    rank = dist.get_rank()
    mesh = make_mesh()
    f = get_field(P.BN128_FR, "cpu")
    n = 1 << LOG_N
    got = {}

    def full(x):                       # this rank's chunk -> global ints
        return f.decode(gather_batch(mesh, x))

    a, b = (shard_batch(mesh, f.encode(spec[k])) for k in ("a", "b"))
    got["sharded_sum"] = f.decode(sharded_sum(f, mesh, a)) == want["sum"]
    got["sharded_dot"] = f.decode(sharded_dot(f, mesh, a, b)) == want["dot"]

    sntt = ShardedNTT(f, LOG_N, mesh)
    y = sntt.ntt(a)
    got["ShardedNTT.ntt"] = full(y) == want["ntt"]
    got["ShardedNTT.intt"] = full(sntt.intt(a)) == want["intt"]
    got["ShardedNTT.intt(ntt)"] = full(sntt.intt(y)) == spec["a"]

    po = ShardedPolyOps(f, LOG_N, mesh)
    pad = [0] * (n // 2)
    ha, hb = (shard_batch(mesh, f.encode(spec[k] + pad))
              for k in ("half_a", "half_b"))
    got["ShardedPolyOps.mul"] = full(po.mul(ha, hb)) == want["mul"] + [0]
    x = replicated(mesh, f.encode(spec["x"]))
    got["ShardedPolyOps.eval_at"] = f.decode(po.eval_at(x, a)) == \
        want["eval_at"]
    for nv in N_VAN:
        q, rem = po.div_by_vanishing(a, nv, f.encode(spec["eta"]))
        wq, wr = want[f"div{nv}"]
        got[f"ShardedPolyOps.div_by_vanishing n_van={nv}"] = (
            full(q) == wq + [0] * nv and f.decode(rem) == wr)
    got["ShardedPolyOps.add/sub/scale"] = (
        full(po.sub(po.add(a, b), b)) == spec["a"]
        and full(po.scale(f.encode(2), a)) == [2 * v % f.p for v in spec["a"]])

    # the MSM and the group FFT against the port's oracle
    ck = get_curves(P.BN128, "cpu")
    og = ck.oracle_g1
    rr = random.Random(spec["seed"])          # the same on every rank
    pts = [og.rnd(rr) for _ in range(4 * size)]
    ks = [rr.randrange(og.r) for _ in range(4 * size)]
    aff = ck.encode_g1(pts)
    res = sharded_msm(ck.msm("g1"), mesh,
                      shard_numpy(mesh, ck.fr.encode(ks, mont=False).numpy()),
                      tuple(shard_batch(mesh, t) for t in aff), c=4)
    got["sharded_msm"] = ck.decode_g1(ck.g1.to_affine(
        tuple(t.unsqueeze(-1) for t in res))) == [og.msm(ks, pts)]
    if size == 2:
        gops = ck.g1
        P4 = gops.from_affine(ck.encode_g1(pts[:4]))
        sg = ShardedGroupFFT(gops, P.BN128_FR, 2, mesh)
        F = sg.fft(tuple(shard_batch(mesh, t) for t in P4))
        Fg = tuple(gather_batch(mesh, t) for t in F)
        got["ShardedGroupFFT.fft"] = ck.decode_g1(gops.to_affine(Fg)) == \
            og.fft(subgroup_gen(P.BN128_FR, 2), pts[:4])
        back = tuple(gather_batch(mesh, t) for t in sg.ifft(F))
        got["ShardedGroupFFT.ifft(fft)"] = ck.decode_g1(
            gops.to_affine(back)) == pts[:4]

    # typed errors: a mesh that is not a power of two, a domain too small
    try:
        ShardedNTT(f, LOG_N, make_mesh(3))
        got["MeshError (mesh of 3)"] = False
    except MeshError:
        got["MeshError (mesh of 3)"] = True
    try:
        ShardedNTT(f, 1, mesh)
        got["DomainSizeError (domain 2^1)"] = False
    except DomainSizeError:
        got["DomainSizeError (domain 2^1)"] = True
    return got if rank == 0 else None


def world_main(rank, size, store, spec, want, out):
    """One rank of the world: join it, run `checks`, leave it; rank 0
    writes the named results to `out`."""
    torch.set_num_threads(1)
    init_multihost(f"file://{store}", size, rank, device="cpu")
    try:
        got = checks(size, spec, want)
    finally:
        dist.destroy_process_group()
    if got is not None:
        with open(out, "w") as fh:
            json.dump(got, fh)


def run_world(size, tmp_path, seed):
    spec = make_inputs(seed)
    want = jax_expected(spec)
    out = tmp_path / "results.json"
    ctx = mp.start_processes(
        world_main, args=(size, str(tmp_path / "store"), spec, want,
                          str(out)),
        nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_SECONDS
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the world of {size} did not end in "
                        f"{WORLD_SECONDS} s")
    got = json.loads(out.read_text())
    failed = [name for name, ok in got.items() if not ok]
    assert not failed, f"world of {size}: failed checks {failed}"
    return got


def test_parallel_world_of_2(tmp_path):
    got = run_world(2, tmp_path, 31)
    assert "ShardedGroupFFT.fft" in got and len(got) == 15


def test_parallel_world_of_4(tmp_path):
    got = run_world(4, tmp_path, 32)
    assert len(got) == 13
