"""The bound of the product's three transforms of the domain over K5's
summed device time per product."""

from zkbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "k5", "ntt_pass_kernel")
