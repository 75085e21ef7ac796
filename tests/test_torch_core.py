"""The port's compile flow is byte-identical to the reference's.

The same designs, compiled by ``repro_torch.core`` and ``repro.core``, must
give identical Calyx text, Verilog (plain and profiled), estimated,
simulated and RTL cycles, interpreter outputs and traced weights.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import frontend as ref_frontend  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro_torch.core import BankConflictError, frontend, pipeline  # noqa: E402

# the two smallest designs of benchmarks/calyx_bench.py, and the paper's FFNN
DESIGNS = {
    "matmul": (lambda fe: fe.Linear(8, 8, bias=False), (4, 8)),
    "conv2d": (lambda fe: fe.Conv2d(2, 2, 3, 3), (2, 6, 6)),
    "ffnn": (lambda fe: fe.paper_ffnn(), (1, 64)),
}


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("opt_level", [0, 2])
@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("design", list(DESIGNS))
def test_compile_matches_reference(design, factor, opt_level, share):
    build, shape = DESIGNS[design]
    kw = dict(factor=factor, opt_level=opt_level, share=share)
    port = pipeline.compile_model(build(frontend), [shape], **kw)
    ref = ref_pipeline.compile_model(build(ref_frontend), [shape], **kw)

    assert port.calyx_text() == ref.calyx_text()
    assert port.emit_verilog() == ref.emit_verilog()
    assert port.emit_verilog(profile=True) == ref.emit_verilog(profile=True)
    assert port.estimate.cycles == ref.estimate.cycles

    assert sorted(port.graph.params) == sorted(ref.graph.params)
    for name, value in ref.graph.params.items():
        np.testing.assert_array_equal(port.graph.params[name], value)

    x = {"arg0": np.random.default_rng(0).normal(size=shape).astype(np.float32)}
    for p, r in zip(port.run(x), ref.run(x)):
        np.testing.assert_array_equal(p, r)
    _, port_sim = port.simulate(x)
    _, ref_sim = ref.simulate(x)
    assert port_sim.cycles == ref_sim.cycles == ref.estimate.cycles
    _, port_rtl = port.simulate_rtl(x)
    _, ref_rtl = ref.simulate_rtl(x)
    assert port_rtl.cycles == ref_rtl.cycles == ref.estimate.cycles


def test_mha_factor4_raises_the_ports_bank_conflict():
    with pytest.raises(BankConflictError):
        pipeline.compile_model(frontend.paper_mha(), [(8, 42)], factor=4)
