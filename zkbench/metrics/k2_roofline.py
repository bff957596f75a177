"""K2's bound on the traced MSM's data (the madds it needs, each byte once)
over K2's device time."""

from zkbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "k2", "bucket_scan_kernel")
