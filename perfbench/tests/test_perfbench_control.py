"""The control: the reference put in the program's place and computed in
float8 (the precision below the configurations' bfloat16) must come out
not correct under each cell's limits.  Here at a size the CPU holds; the
readings that set the limits were taken on the card at the cells' own
sizes (PERF.md)."""
import json

import pytest

from conftest import SERVE_LIMITS, SERVE_WORKLOAD as SERVE, tiny
from perfbench import calibrate, cells, verdict

TRAIN = "granite-moe-1b-a400m.train-4k"


def _readings(workload, capsys, seeds="21,22,23"):
    ov = tiny(workload)
    if workload == SERVE:
        ov["traffic"].update(check_tokens=120)
    rc = calibrate.main(["--workload", workload, "--seeds", seeds,
                         "--seconds", "0.6", "--control"], device="cpu",
                        overrides=ov)
    assert rc == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_serve_control_is_refused(capsys):
    margin = str(SERVE_LIMITS["logit_err_share"]["margin"])
    for r in _readings(SERVE, capsys):
        for k, ok in (("program", True), ("control", False), ("altered", False)):
            share = {"logit_err_share": r[k]["over"][margin]}
            assert verdict.judge(share, SERVE_LIMITS)[0] is ok, (k, r[k])


def test_train_control_and_half_batch_are_refused(capsys):
    limits = cells.run_limits(TRAIN)
    for r in _readings(TRAIN, capsys):
        assert verdict.judge(r["program"], limits)[0]
        assert not verdict.judge(r["control"], limits)[0]
        assert not verdict.judge(r["half_batch"], limits)[0]


@pytest.mark.parametrize("workload", [w["name"] for w in cells.benchmark()["workloads"]])
def test_limits_lie_between_their_readings(workload):
    for name, v in cells.run_limits(workload).items():
        assert v["lower"] < v["limit"] < v["upper"], name
        # more room above the lower reading than below the upper one
        assert v["limit"] / v["lower"] >= v["upper"] / v["limit"] / 2, name
