"""Points of the window's whole MSMs over their summed time."""

from zkbench.readers import rate as read  # noqa: F401
