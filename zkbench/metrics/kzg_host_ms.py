"""The host's time per blob operation: the host interval of the port's
span `kzg.blob_prove` per call in its registry, the device-to-host wait
of the challenge included.  None where the port has no span registry or
the registry holds no `kzg.blob_prove` call."""

from zkbench.registry import span_per_op


def read(rec):
    return span_per_op("kzg.blob_prove", "host_s", "kzg.blob_prove")
