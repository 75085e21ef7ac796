"""Training cells read by layer: the training driver's run (``train_driver``:
set-up, the checked steps, the window and, in a traced run, its full
traced steps), then, in a traced run only and after the window has closed,
``ranges_steps`` more steps of the same state in the ranges-only window
(``attribution.RangesWindow``), whose summary the range readers of
``metrics/`` read from ``rec["ranges"]``.

The ranges-only window is traced again (up to 4 times) unless its device
work spans 0.97-1.01 of the CUDA events around it (C.21).  Its steps run
with a ``MetricsRegistry`` on the train step, and each attempt logs the
registry's counters (their change over the attempt's steps).  Nothing of
it is in the window, so the end-to-end metrics and ``mfu.train`` are the
training driver's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench import attribution, train_driver
from perfbench.train_driver import check, end_to_end, reference  # noqa: F401


def run(cfg_file: Dict, port_cfg, spec: Dict, params, seed: int,
        seconds: float, trace: bool, device, t_start: float, log) -> Dict:
    rec = train_driver.run(cfg_file, port_cfg, spec, params, seed, seconds,
                           trace, device, t_start, log)
    if trace:
        rec["ranges"] = ranges_window(port_cfg, spec, rec, device, log)
    return rec


def ranges_window(port_cfg, spec: Dict, rec: Dict, device, log
                  ) -> Optional[Dict]:
    """The trusted ranges-only window over ``spec["ranges_steps"]`` steps of
    ``rec["state"]`` (its ``steps`` added), or None where no attempt was
    trusted on a card.  ``rec["state"]`` is left at the last step."""
    from repro_torch.launch import steps as ST
    from repro_torch.obs import MetricsRegistry
    from repro_torch.optim import adamw

    reg = MetricsRegistry()
    step_fn = ST.make_train_step(
        port_cfg, adamw.AdamWConfig(**spec["optimizer"]), metrics=reg)
    batches = torch.from_numpy(rec["pool"]).to(device)
    n = spec.get("ranges_steps", 2)
    i = spec["checked_steps"] + rec["steps"]
    last: Dict[str, float] = {}
    for attempt in range(4):
        w = attribution.RangesWindow(device)
        with w:
            for _ in range(n):
                rec["state"], m = step_fn(
                    rec["state"], {"tokens": batches[i % len(batches)]})
                float(m["loss"])
                i += 1
        summary = w.read()
        now = {name: reg.get(name).value for name in reg.names()}
        log(f"ranges window {attempt}: span/events "
            f"{summary.get('span_ratio')} trusted {summary.get('trusted')}; "
            "counters over its steps "
            f"{ {k: v - last.get(k, 0) for k, v in sorted(now.items())} }")
        last = now
        if summary.get("trusted") or device.type != "cuda":
            summary["steps"] = n
            return summary
    return None
