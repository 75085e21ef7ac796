"""Device ms a step of the kernels launched inside the harness's range
around the port's decode attention (``models.attention.attn_decode``)."""
RANGE = "perfbench.attn_decode"


def read(run):
    t = run.trace
    r = (t or {}).get("ranges", {}).get(RANGE)
    steps = len(run.rec.get("traced", []))
    if not r or r["device_s"] <= 0 or not steps:
        return None
    return r["device_s"] / steps * 1e3
