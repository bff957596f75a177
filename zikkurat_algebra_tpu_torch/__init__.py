"""PyTorch and CUDA port of zikkurat_algebra_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package runs the G1 and G2
Pippenger MSMs, the Fr NTT, polynomial and group-FFT path, the pairing
and the KZG commitment on an H100 through hand-written CUDA kernels
(ops/kernel_field.py, kernel_curve.py, kernel_sort.py, kernel_ntt.py)
and imports neither JAX nor the JAX package.

Entry points: `api.bn128()`, `api.bls12_381()` and `api.curve_api(name)`
(fields, tower, groups, MSMs, NTT domains, group FFTs, the pairing of one
curve family), `ops.bigint.bigint(bits)` (fixed-width integers),
`protocols.kzg`, `utils.profiling` and `parallel` (one process per
device over torch.distributed: `mesh`, `sharded_sum` / `sharded_dot`,
`sharded_msm`, `ShardedNTT`, `ShardedPolyOps`, `ShardedGroupFFT`).  Each
runs on "cuda" unless the caller passes device="cpu".

`utils.profiling` holds the port's stage spans (`msm.std` and its seven
stages, `poly.mul_ntt` and its transforms, `curve.to_affine`, `kzg.*`,
`pairing.*`): off by default, `zk.<name>` ranges under a
`torch.profiler` (`profiling.trace`), and records of host and device
intervals (CUDA events) and kernel launches under
`profiling.recording()`, read by `profiling.totals()`; an MSM's
`stage_seconds` is built on them.  Besides: trace, timed, force,
Counters.
"""
