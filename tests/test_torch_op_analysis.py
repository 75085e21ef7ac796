"""The op-level cost counter against known-cost programs and against the
reference's HLO analysis on the same programs (the twin of
``tests/test_hlo_analysis.py``).

Eager PyTorch has no loop body to multiply: a Python loop of products
counts each product as it runs, where the reference multiplies a ``scan``
body by its trip count; both must give the same FLOPs.  Traffic is exact
here (every eager op a kernel boundary), where the reference bands XLA's
fused traffic.  The mesh cases need a fake process group, one per process,
so they run in a subprocess (``torch_mesh_counts.py``, which the card
tests also run with fake CUDA tensors).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.obs import modelprof as RMPF  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402
from repro_torch.models import decode  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import params as MP  # noqa: E402
from repro_torch.obs import modelprof as MPF  # noqa: E402

import torch_mesh_counts  # noqa: E402

S = jax.ShapeDtypeStruct
MB = 1024 * 1024 * 4


def _hlo(fn, *specs):
    return H.analyze(jax.jit(fn).lower(*specs).compile().as_text())


def _rand(*shape):
    return torch.from_numpy(np.random.default_rng(0).normal(
        size=shape).astype(np.float32))


class TestFlops:
    def test_single_product(self):
        cost = OA.analyze(lambda a, b: a @ b, _rand(64, 32), _rand(32, 16))
        assert cost.flops == 2 * 64 * 32 * 16
        ref = _hlo(lambda a, b: a @ b, S((64, 32), jnp.float32),
                   S((32, 16), jnp.float32))
        assert cost.flops == pytest.approx(ref.flops, rel=MPF.FLOPS_RTOL)

    def test_loop_of_layers(self):
        """A Python loop counts every layer; the reference's scan over the
        same layers multiplies its body by the trip count."""
        def unrolled(x, w):
            for _ in range(8):
                x = x @ w
            return x

        def scanned(x, w):
            out, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                                  length=8)
            return out
        cost = OA.analyze(unrolled, _rand(128, 128), _rand(128, 128))
        assert cost.flops == 2 * 128 ** 3 * 8
        ref = _hlo(scanned, *(S((128, 128), jnp.float32),) * 2)
        assert cost.flops == pytest.approx(ref.flops, rel=MPF.FLOPS_RTOL)

    def test_batched_product(self):
        cost = OA.analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                          _rand(4, 8, 16), _rand(4, 16, 8))
        assert cost.flops == 2 * 4 * 8 * 16 * 8
        ref = _hlo(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                   S((4, 8, 16), jnp.float32), S((4, 16, 8), jnp.float32))
        assert cost.flops == pytest.approx(ref.flops, rel=MPF.FLOPS_RTOL)

    def test_reduced_qwen2_decode_step(self):
        """The port's serve step against the reference's compiled one:
        both count exactly the step's products."""
        cfg, rcfg = get_config("qwen2-0.5b").reduced(), \
            ref_config("qwen2-0.5b").reduced()
        params = MP.init_params(cfg, seed=0, device="cpu")
        cache = decode.init_cache(cfg, params, 2, 32)
        toks = torch.zeros((2, 1), dtype=torch.long)
        cost = OA.analyze(decode.serve_step, cfg, params, cache, toks, 0)
        ref = H.analyze(RMPF.decode_step_hlo(rcfg, 2, 32))
        assert cost.flops == pytest.approx(ref.flops, rel=MPF.FLOPS_RTOL)
        assert cost.total_collective_bytes == 0


class TestTraffic:
    def test_elementwise_traffic(self):
        """Two kernels: ``b * 2`` (read b, write t), ``a + t`` (read a and
        t, write the result): five buffers, where XLA fuses three."""
        cost = OA.analyze(lambda a, b: a + b * 2.0, _rand(1024, 1024),
                          _rand(1024, 1024))
        assert cost.traffic_bytes == 5 * MB
        ref = _hlo(lambda a, b: a + b * 2.0, S((1024, 1024), jnp.float32),
                   S((1024, 1024), jnp.float32))
        assert 2 * MB <= ref.traffic_bytes <= cost.traffic_bytes

    def test_views_count_nothing(self):
        def views(x):
            y = x.view(512, 2048).t().reshape(2048, 512)
            z = x.permute(1, 0).unsqueeze(0).expand(3, 1024, 1024)
            return y[3], z[:, 5:9], x.select(0, 2), x.as_strided((4, 4), (1, 4))
        counter = OA.run_counted(views, _rand(1024, 1024))[1]
        assert counter.ops > 0
        assert counter.traffic_bytes == 0 and counter.flops == 0

    def test_slice_write_counts_the_slice(self):
        """Writing a row into a buffer reads and writes the row, not the
        buffer (``dynamic-update-slice``); so does ``index_put_``."""
        def write(buf, row, idx):
            buf[3] = row
            buf.index_put_((idx,), row[None].expand(2, 1024))
            return buf
        idx = torch.tensor([1, 7])
        cost = OA.analyze(write, torch.zeros(1024, 1024), _rand(1024), idx)
        assert cost.traffic_bytes == 2 * 1024 * 4 + 2 * (2 * 1024 * 4 + 16)

    def test_gather_counts_the_rows(self):
        idx = torch.tensor([3, 5, 9])
        cost = OA.analyze(lambda t, i: t[i], _rand(1024, 64), idx)
        assert cost.traffic_bytes == 2 * 3 * 64 * 4 + 3 * 8

    def test_peak_live_bytes(self):
        """The arguments, then one 4 MB temporary at a time."""
        def chain(x):
            for _ in range(4):
                x = x * 2.0
            return x
        counter = OA.run_counted(chain, _rand(1024, 1024))[1]
        assert counter.peak_live_bytes == 3 * MB


@pytest.fixture(scope="module")
def mesh_counts():
    return torch_mesh_counts.counts("cpu")


def test_sharded_product_counts_per_device(mesh_counts):
    """On a 16x16 fake mesh a product sharded over both axes counts
    2·M·N·K / 256 per device; DTensor's run of the op on the global shapes
    (to propagate its metadata) is not counted, the first time or after."""
    torch_mesh_counts.check_product(mesh_counts)


def test_sum_over_a_mesh_all_reduces(mesh_counts):
    """The case the reference skips without 8 devices: a sum over a
    sharded axis moves one row per device."""
    torch_mesh_counts.check_sum(mesh_counts)
