"""The MoE block's share of its roofline over the traced steps: the least
time its inputs allow (``counts.moe_call``: the router, the assignments
the capacity keeps, the experts they reach, the tokens in and out), from
each traced call's routing, over the device time of its range."""
from perfbench import counts

RANGE = "perfbench.moe_block"


def read(run):
    t = run.trace
    r = (t or {}).get("ranges", {}).get(RANGE)
    routes = run.rec.get("routes", [])
    if not r or r["device_s"] <= 0 or not routes:
        return None
    c = run.cfg
    least = 0.0
    for top_i in routes:
        tokens = top_i.shape[0]
        got = counts.moe_routing(c, top_i.cpu().numpy(), tokens)
        x = counts.moe_call(c, tokens, got["kept"], got["hit"])
        least += counts.least_time_s(x["flops"], x["bytes"])
    return 100.0 * least / r["device_s"]
