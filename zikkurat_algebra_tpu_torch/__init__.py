"""PyTorch and CUDA port of zikkurat_algebra_tpu for NVIDIA Hopper.

The JAX package stays the reference; this package runs the G1 Pippenger
MSM on an H100 through hand-written CUDA kernels (ops/kernel_field.py,
ops/kernel_curve.py) and imports neither JAX nor the JAX package.
"""
