"""Device ms a step of the kernels launched inside the program's range
``train_step.grads`` (forward, recomputation and backward)."""
RANGE = "train_step.grads"


def read(run):
    t = run.trace
    r = (t or {}).get("ranges", {}).get(RANGE)
    steps = run.rec.get("traced_steps", 0)
    if not r or r["device_s"] <= 0 or not steps:
        return None
    return r["device_s"] / steps * 1e3
