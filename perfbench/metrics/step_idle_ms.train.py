"""Idle ms a step of the ranges-only window: its length by the CUDA events
around it, less the time some kernel, copy or fill ran
(``perfbench.attribution``)."""


def read(run):
    r = run.rec.get("ranges") or {}
    if r.get("busy_s", 0) <= 0 or not r.get("steps"):
        return None
    return (r["window_s"] - r["busy_s"]) / r["steps"] * 1e3
