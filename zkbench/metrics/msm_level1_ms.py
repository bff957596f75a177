"""The MSM's level 1 (bucket_scan, kernel K2) per call (the port's stage_seconds)."""

from zkbench.readers import stage_ms


def read(rec):
    return stage_ms(rec, "bucket_scan")
