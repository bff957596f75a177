"""The host's time issuing one MSM: the host interval of the port's span
`msm.std` per call in its registry (the traced window, whose MSMs are
handed `stage_seconds`); the span holds no wait for the card.  None
where the port has no span registry or it holds no `msm.std` call."""


def read(rec):
    try:
        from zikkurat_algebra_tpu_torch.utils import profiling
    except ImportError:
        return None
    totals = getattr(profiling, "totals", None)
    if totals is None:
        return None
    calls = totals().get("msm.std", {})
    if not calls.get("calls"):
        return None
    return 1e3 * calls["host_s"] / calls["calls"]
