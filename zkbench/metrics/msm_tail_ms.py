"""The MSM's weighted bucket sum and Horner pass per call (the port's stage_seconds)."""

from zkbench.readers import stage_ms


def read(rec):
    return stage_ms(rec, "weighted_sum", "horner")
