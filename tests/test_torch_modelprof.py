"""The port's roofline classes, offload ranking and analytic cross-check
against the reference's (the twins of ``tests/test_modelprof.py``'s
``TestAnalyticModel`` cases).  The port's peaks are the H100's datasheet
figures, the reference's the TPU v5e's, so rankings are compared under the
same explicit peaks."""
import pytest

pytest.importorskip("torch")

from repro.models import get_config as ref_config  # noqa: E402
from repro.obs import modelprof as RMPF  # noqa: E402
from repro_torch.launch import op_stats  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models.decode import profile_ops  # noqa: E402
from repro_torch.obs import modelprof as MPF  # noqa: E402


def test_roofline_class_ridge():
    peaks = (100.0, 10.0)          # ridge at 10 FLOPs/byte
    assert MPF.roofline_class(5.0, peaks) == "memory"
    assert MPF.roofline_class(20.0, peaks) == "compute"
    ridge = op_stats.PEAK_FLOPS_BF16 / op_stats.HBM_BW      # ~295
    assert MPF.device_peaks() == (989.4e12, 3.35e12)
    assert MPF.roofline_class(ridge * 0.99) == "memory"
    assert MPF.roofline_class(ridge) == "compute"


def test_offload_report_ranked_by_share():
    cfg, rcfg = get_config("qwen2-0.5b").reduced(), \
        ref_config("qwen2-0.5b").reduced()
    prof, rprof = MPF.LayerProfiler(), RMPF.LayerProfiler()
    ops = profile_ops(cfg)
    walls = [100.0 if op == "attn" else 10.0 for op, _ in ops]
    prof.on_step(0, ops, walls, ts_us=0)
    rprof.on_step(0, ops, walls, ts_us=0)
    costs = MPF.analytic_op_costs(cfg, batch=1, cache_len=4096)
    rows = MPF.offload_report(cfg, prof.records, costs)
    assert rows[0]["op"] == "attn" and rows[0]["rank"] == 1
    assert [r["rank"] for r in rows] == list(range(1, len(rows) + 1))
    shares = [r["share"] for r in rows]
    assert shares == sorted(shares, reverse=True)
    assert all(r["bound"] in ("compute", "memory") for r in rows)
    peaks = MPF.device_peaks()
    assert MPF.offload_report(cfg, prof.records, costs, peaks) == \
        RMPF.offload_report(rcfg, rprof.records,
                            RMPF.analytic_op_costs(rcfg, 1, 4096), peaks)


def test_crosscheck_qwen():
    """The analytic FLOPs and bytes against the op counter's count of the
    port's decode step, with the reference's constants."""
    assert (MPF.FLOPS_RTOL, MPF.BYTES_FACTOR) == \
        (RMPF.FLOPS_RTOL, RMPF.BYTES_FACTOR)
    cfg = get_config("qwen2-0.5b").reduced()
    report, problems = MPF.crosscheck(cfg, batch=2, cache_len=32,
                                      device="cpu")
    assert problems == [], (report, problems)
    assert report["flops_rel_err"] <= MPF.FLOPS_RTOL
    assert (1.0 / MPF.BYTES_FACTOR <= report["bytes_ratio"]
            <= MPF.BYTES_FACTOR)
    assert report["collective_bytes"] == 0
    rreport, _ = RMPF.crosscheck_hlo(ref_config("qwen2-0.5b").reduced(),
                                     batch=2, cache_len=32)
    assert report["analytic_flops"] == rreport["analytic_flops"]
    assert report["analytic_bytes"] == rreport["analytic_bytes"]
    assert report["counted_flops"] == rreport["hlo_flops"]
