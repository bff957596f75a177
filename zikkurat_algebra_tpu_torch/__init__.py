"""PyTorch and CUDA port of zikkurat_algebra_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package runs the G1 and G2
Pippenger MSMs, the Fr NTT, polynomial and group-FFT path, the pairing
and the KZG commitment on an H100 through hand-written CUDA kernels
(ops/kernel_field.py, kernel_curve.py, kernel_sort.py, kernel_ntt.py)
and imports neither JAX nor the JAX package.

Entry points: `api.bn128()`, `api.bls12_381()` and `api.curve_api(name)`
(fields, tower, groups, MSMs, NTT domains, group FFTs, the pairing of one
curve family), `ops.bigint.bigint(bits)` (fixed-width integers),
`protocols.kzg`, `utils.profiling` (trace, timed, Counters) and
`parallel` (one process per device over torch.distributed: `mesh`,
`sharded_sum` / `sharded_dot`, `sharded_msm`, `ShardedNTT`,
`ShardedPolyOps`, `ShardedGroupFFT`).  Each runs on "cuda" unless the
caller passes device="cpu".
"""
