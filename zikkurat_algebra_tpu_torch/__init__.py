"""PyTorch and CUDA port of zikkurat_algebra_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package runs the G1 and G2
Pippenger MSMs, the Fr NTT, polynomial and group-FFT path, the pairing
and the KZG commitment on an H100 through hand-written CUDA kernels
(ops/kernel_field.py, kernel_curve.py, kernel_sort.py, kernel_ntt.py)
and imports neither JAX nor the JAX package.
"""
