"""The banked-kernel backend against the reference's Pallas backend.

``execute_graph_cuda(device="cpu")`` (matmuls through the kernel's plain
version) against ``execute_graph_pallas`` (the Pallas kernel in interpret
mode) on the paper's three models at every factor that compiles, at the
reference's design tolerance of 1e-4.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import frontend as ref_frontend  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core.pallas_backend import execute_graph_pallas  # noqa: E402
from repro_torch.core import frontend, pipeline  # noqa: E402
from repro_torch.core.cuda_backend import execute_graph_cuda  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# model, input shape, factors that compile (the others raise BankConflictError)
CASES = [("paper_ffnn", (1, 64), f) for f in (1, 2, 4)] + \
        [("paper_mha", (8, 42), f) for f in (1, 2)] + \
        [("paper_cnn", (3, 80, 60), 1)]


@pytest.mark.parametrize("name,shape,factor", CASES)
def test_banked_backend_matches_pallas_backend(name, shape, factor):
    port = pipeline.compile_model(getattr(frontend, name)(), [shape], factor=factor)
    ref = ref_pipeline.compile_model(getattr(ref_frontend, name)(), [shape],
                                     factor=factor)
    x = {"arg0": np.random.default_rng(0).normal(size=shape).astype(np.float32)}
    got = execute_graph_cuda(port.graph, x, port.spec, device="cpu")
    want = execute_graph_pallas(ref.graph, x, ref.spec)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_quickstart_twin_matches_reference_cycles():
    env = {**os.environ, "PYTHONPATH": "src"}
    r = subprocess.run([sys.executable, "examples/quickstart_torch.py",
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    cycles = {int(f): int(c) for f, c in
              re.findall(r"factor=(\d): cycles=\s*(\d+)", r.stdout)}
    want = {f: ref_pipeline.compile_model(ref_frontend.paper_ffnn(), [(1, 64)],
                                          factor=f).estimate.cycles
            for f in (1, 2, 4)}
    assert cycles == want
    assert r.stdout.count("correct=True") == 3
    assert r.stdout.count("banked_backend=True") == 3
