"""Median host-clock wall of one engine round, ``admit()`` + ``step()``
(the step ends in the engine's own synchronize), over the window."""
import statistics


def read(run):
    walls = run.rec.get("step_walls")
    return statistics.median(walls) * 1e3 if walls else None
