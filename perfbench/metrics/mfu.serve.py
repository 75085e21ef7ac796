"""Model FLOPs of every token fed to an occupied slot in the window
(``counts.serve_token_flops`` over its request's own context) over the
window's host-clock seconds times the chip's bf16 peak; the profiled steps
and the trace's reading are left out of both."""
from perfbench import counts


def read(run):
    flops = run.rec.get("untraced_flops", 0.0)
    secs = run.rec.get("untraced_s", 0.0)
    if flops <= 0 or secs <= 0:
        return None
    return 100.0 * flops / (secs * counts.PEAKS["bf16_flops"])
