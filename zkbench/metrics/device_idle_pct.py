"""Device idle share of the traced ops against their untraced wall time."""

from zkbench.readers import idle_pct as read  # noqa: F401
