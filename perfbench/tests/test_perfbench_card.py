"""On the card: a short run of each cell comes out correct and reports
every metric it owes (``pytest -m cuda perfbench/tests``)."""
import json

import pytest

from perfbench import cells, run

WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_short_run_on_the_card(workload, trace, capsys):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rc = run.main(["--workload", workload, "--seed", str(2**31 + 101),
                   "--seconds", "10", "--trace", str(trace)])
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] is True
    cell = cells.cell(cells.benchmark(), workload)
    owed = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(last["metrics"]) == {m["name"] for m in owed}
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1
