"""Model FLOPs of the window's training steps (``counts.train_step_flops``)
over the window's host-clock seconds times the chip's bf16 peak; the
profiled steps and the trace's reading are left out of both."""
from perfbench import counts


def read(run):
    steps = run.rec.get("untraced_steps", 0)
    secs = run.rec.get("untraced_s", 0.0)
    if not steps or secs <= 0:
        return None
    flops = steps * counts.train_step_flops(run.cfg, run.spec["batch"],
                                            run.spec["seq_len"])
    return 100.0 * flops / (secs * counts.PEAKS["bf16_flops"])
