"""The blob commitments per operation: the device interval of the port's
span `kzg.blob_commit` (the commitment MSMs, their one `to_affine` and
the 48-byte encoding) over the calls of `kzg.blob_prove` in its registry
(the traced window, which the operation records).  None where the port
has no span registry or the registry holds no `kzg.blob_prove` call."""

from zkbench.registry import span_per_op


def read(rec):
    return span_per_op("kzg.blob_commit", "device_s", "kzg.blob_prove")
