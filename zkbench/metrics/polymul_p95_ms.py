"""95th percentile of every product's time in the window."""

from zkbench.readers import percentile_ms


def read(rec):
    return percentile_ms(rec, 95)
