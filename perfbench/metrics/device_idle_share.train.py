"""Share of the traced window in which no kernel, copy or fill ran on the
device (the window's length by CUDA events around it)."""


def read(run):
    t = run.trace
    if not t or "busy_s" not in t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
