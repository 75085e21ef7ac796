"""The decode attention's share of its roofline over the traced steps: the
least time its inputs allow (``counts.attn_decode_call`` for every slot at
each traced step's position, each layer) over the device time of its
range."""
from perfbench import counts

RANGE = "perfbench.attn_decode"


def read(run):
    t = run.trace
    r = (t or {}).get("ranges", {}).get(RANGE)
    traced = run.rec.get("traced", [])
    if not r or r["device_s"] <= 0 or not traced:
        return None
    c = run.cfg
    least = 0.0
    for s in traced:
        x = counts.attn_decode_call(c, s["slots"], s["pos"])
        least += counts.least_time_s(x["flops"], x["bytes"]) * c["num_layers"]
    return 100.0 * least / r["device_s"]
