"""Protocols over the port's kernels: the KZG commitment and its SRS
files."""
