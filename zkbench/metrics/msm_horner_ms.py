"""The MSM's Horner pass per call: the device interval of the port's span
`msm.horner` over the calls of `msm.std` in its registry (the traced
window, whose MSMs are handed `stage_seconds`).  None where the port has
no span registry or the registry holds no `msm.std` call."""


def read(rec):
    try:
        from zikkurat_algebra_tpu_torch.utils import profiling
    except ImportError:
        return None
    totals = getattr(profiling, "totals", None)
    if totals is None:
        return None
    t = totals()
    calls = t.get("msm.std", {}).get("calls", 0)
    if not calls or "msm.horner" not in t:
        return None
    return 1e3 * t["msm.horner"]["device_s"] / calls
