"""The blob openings per operation: the device interval of the port's
span `kzg.blob_open` (evaluation, quotient, proof MSMs, their one
`to_affine` and the 48-byte encoding) over the calls of `kzg.blob_prove`
in its registry.  None where the port has no span registry or the
registry holds no `kzg.blob_prove` call."""

from zkbench.registry import span_per_op


def read(rec):
    return span_per_op("kzg.blob_open", "device_s", "kzg.blob_prove")
