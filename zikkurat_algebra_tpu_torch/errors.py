"""Typed errors raised at the port's API boundaries."""

from __future__ import annotations


class ZikkuratError(ValueError):
    """Base class for all boundary-validation errors."""


class DimensionError(ZikkuratError):
    """Array dimensions incompatible with the requested operation."""


class UnsupportedError(ZikkuratError):
    """The curve family does not support the requested group."""
