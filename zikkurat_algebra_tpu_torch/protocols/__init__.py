"""Protocols over the port's kernels: the KZG commitment and its SRS
files, and the EIP-4844 blob prover."""
