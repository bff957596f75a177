"""Typed errors raised at the port's API boundaries."""

from __future__ import annotations


class ZikkuratError(ValueError):
    """Base class for all boundary-validation errors."""


class DimensionError(ZikkuratError):
    """Array dimensions incompatible with the requested operation."""


class DomainSizeError(ZikkuratError):
    """NTT or group-FFT domain size and array length disagree, or the
    field has no domain of that size."""


class MeshError(ZikkuratError):
    """Device-mesh shape unsupported by the sharded function, or this
    process not in the mesh."""


class UnsupportedError(ZikkuratError):
    """The curve family does not support the requested group."""
