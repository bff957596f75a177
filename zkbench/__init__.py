"""The benchmark of zikkurat_algebra_tpu_torch on one NVIDIA H100: its
harness (run.py), the plain reference (bls.py), the yardstick (counts.py,
inputs.py, readers.py) and, found by name, the configurations, traffic
mixes, operation modules and metric readers."""
