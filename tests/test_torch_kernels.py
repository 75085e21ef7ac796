"""The port's banked matmul against the reference's Pallas kernel.

On the CPU ``ops.matmul`` takes the plain version; it is held against the
reference's ``ops.matmul`` in interpret mode on every case of
``tests/test_kernels.py::TestBankedMatmul``, at that file's tolerances.  The
CUDA kernel itself runs only on the card (``tests/test_torch_card.py``, and
``chip_smoke.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.banked_matmul import derive_block as ref_derive_block  # noqa: E402
from repro_torch.core import cuda_backend, frontend  # noqa: E402
from repro_torch.core.banking import BankingSpec  # noqa: E402
from repro_torch.kernels import banked_matmul as bm  # noqa: E402
from repro_torch.kernels import checks, ops  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, dict(rtol=2e-5, atol=2e-5)),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2e-2, atol=2e-2))}
SHAPES = [(8, 16, 8), (32, 64, 48), (48, 64, 40), (1, 64, 48), (17, 33, 9),
          (128, 128, 128)]
BANKS = [(1, 1, 1), (2, 2, 2), (4, 2, 1), (1, 4, 4)]


def _pair(x: np.ndarray, dtype: str):
    """The same values for both packages: float32 first, then the dtype."""
    t, j, _ = DTYPES[dtype]
    x = x.astype(np.float32)
    return torch.from_numpy(x).to(t), jnp.asarray(x).astype(j)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shapes_dtypes_match_reference(m, k, n, dtype):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, ja = _pair(rng.normal(size=(m, k)), dtype)
    b, jb = _pair(rng.normal(size=(k, n)), dtype)
    out = ops.matmul(a, b, banks=(2, 2, 2))
    assert out.dtype == DTYPES[dtype][0] and out.shape == (m, n)
    np.testing.assert_allclose(_f32(out), _f32(ref_ops.matmul(ja, jb, banks=(2, 2, 2))),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("banks", BANKS)
def test_bank_partitions_match_reference(banks):
    rng = np.random.default_rng(7)
    a, ja = _pair(rng.normal(size=(64, 96)), "float32")
    b, jb = _pair(rng.normal(size=(96, 64)), "float32")
    np.testing.assert_allclose(_f32(ops.matmul(a, b, banks=banks)),
                               _f32(ref_ops.matmul(ja, jb, banks=banks)),
                               rtol=2e-5, atol=2e-5)


def test_transposed_view_operand():
    """``kh.t()`` in the paper's MHA reaches the matmul as a strided view."""
    rng = np.random.default_rng(11)
    a, ja = _pair(rng.normal(size=(8, 21)), "float32")
    bt, jbt = _pair(rng.normal(size=(8, 21)), "float32")
    np.testing.assert_allclose(_f32(ops.matmul(a, bt.t())),
                               _f32(ref_ops.matmul(ja, jbt.T)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("banks", BANKS + [(2, 4, 8), (3, 5, 7), (8, 8, 8)])
def test_derive_block_matches_reference(banks):
    dims = (1, 7, 8, 17, 42, 64, 127, 128, 129, 300, 1024, 5472)
    for m, n, k in itertools.product(dims, repeat=3):
        assert bm.derive_block(m, n, k, banks) == ref_derive_block(m, n, k, banks)


def test_f32_accumulation_for_bf16():
    out = ops.matmul(torch.ones(8, 512, dtype=torch.bfloat16),
                     torch.ones(512, 8, dtype=torch.bfloat16),
                     out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert bool((out == 512.0).all())


def test_cpu_path_counts_no_launch():
    before = bm.launches
    ops.matmul(torch.ones(4, 4), torch.ones(4, 4), banks=(2, 2, 2))
    g = frontend.trace(frontend.paper_ffnn(), [(1, 64)])
    cuda_backend.execute_graph_cuda(g, {"arg0": np.zeros((1, 64), np.float32)},
                                    BankingSpec(factor=2), device="cpu")
    assert bm.launches == before == 0


def test_cuda_request_raises_here(monkeypatch):
    """No fallback: without a card a CUDA request raises, and the kernel
    refuses tensors that are not on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = frontend.trace(frontend.paper_ffnn(), [(1, 64)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_backend.execute_graph_cuda(g, {"arg0": np.zeros((1, 64), np.float32)},
                                        BankingSpec(factor=1), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_backend.execute_graph_cuda(g, {"arg0": np.zeros((1, 64), np.float32)},
                                        BankingSpec(factor=1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bm.banked_matmul(torch.ones(4, 4), torch.ones(4, 4))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.matmul(torch.ones(4, 4, device="meta"), torch.ones(4, 4, device="meta"))


@pytest.mark.parametrize("a_shape,b_shape,kw,err", [
    ((4, 5), (4, 5), {}, ValueError),                               # K mismatch
    ((4,), (4, 5), {}, ValueError),                                 # not 2-D
    ((0, 5), (5, 3), {}, ValueError),                               # empty
    ((4, 5), (5, 3), {"banks": (0, 1, 1)}, ValueError),
    ((4, 5), (5, 3), {"block": (8, 8)}, ValueError),
    ((4, 5), (5, 3), {"out_dtype": torch.float16}, TypeError),
])
def test_operands_are_checked(a_shape, b_shape, kw, err):
    with pytest.raises(err):
        ops.matmul(torch.ones(a_shape), torch.ones(b_shape), **kw)


def test_dtypes_are_checked():
    with pytest.raises(TypeError):
        ops.matmul(torch.ones(4, 5, dtype=torch.float16),
                   torch.ones(5, 3, dtype=torch.float16))
    with pytest.raises(TypeError):
        ops.matmul(torch.ones(4, 5), torch.ones(5, 3, dtype=torch.bfloat16))


# The plan: which variant runs and how a product is cut (kernels/banked_matmul.py)
PLAN_SHAPES = ([(m, k, n) for m, k, n, _, _ in checks.MAIN_PATH_MATMULS]
               + SHAPES + [(16, 300, 40), (17, 300, 40), (1, 65536, 8),
                           (12, 40000, 24), (5, 1001, 13), (3, 777, 50),
                           (16, 100, 200), (130, 70, 300)])


def _cover(m, n, k, block):
    """How often each (row, column) of C is computed, and each piece's
    blocks (it must sum its K range once per split)."""
    count = np.zeros((m, n), np.int64)
    spans = {}
    for _, (r0, r1, c0, c1, k0, k1) in bm.tiles(m, n, k, block):
        assert 0 <= r0 < r1 <= m and 0 <= c0 < c1 <= n and 0 <= k0 < k1 <= k
        count[r0:r1, c0:c1] += 1
        spans.setdefault((r0, r1, c0, c1), []).append((k0, k1))
    return count, spans


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_covers_every_output_once(m, k, n, banks):
    """Each output of C is computed once in each K split, and the splits of
    each piece partition K."""
    block = bm.derive_block(m, n, k, banks)
    p = bm.plan(m, n, k, block)
    count, spans = _cover(m, n, k, block)
    assert (count == p.splits).all()
    for pieces in spans.values():
        assert sorted(pieces) == [(z * p.ksplit, min(k, (z + 1) * p.ksplit))
                                  for z in range(p.splits)]


@pytest.mark.parametrize("banks", BANKS + [(3, 5, 7), (8, 8, 8)])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_blocks_stay_inside_bank_tiles(m, k, n, banks):
    """No block straddles a bank boundary of C, and its threads fit."""
    block = bm.derive_block(m, n, k, banks)
    p = bm.plan(m, n, k, block)
    assert p.skinny == (m <= bm.SKINNY_MAX_M)
    assert 32 <= p.threads <= (bm.MAX_THREADS if p.skinny else bm.TILED_THREADS)
    bmm, bnn, _ = block
    blocks = {}
    for idx, (r0, r1, c0, c1, _, _) in bm.tiles(m, n, k, block):
        lo, hi = blocks.get(idx, ((r0, c0), (r1, c1)))
        blocks[idx] = (min(lo, (r0, c0)), (max(hi[0], r1), max(hi[1], c1)))
    for (r0, c0), (r1, c1) in blocks.values():
        assert r0 // bmm == (r1 - 1) // bmm and c0 // bnn == (c1 - 1) // bnn


def test_main_path_takes_the_skinny_variant():
    """The matmuls of the paper's designs as the port compiles them are the
    17 of ``checks.MAIN_PATH_MATMULS``, and every one runs the skinny
    variant in one pass over K (no split), about 8 k values a thread."""
    from repro_torch.core import pipeline
    found = set()
    for name, shape, factors in (("paper_ffnn", (1, 64), (1, 2, 4)),
                                 ("paper_mha", (8, 42), (1, 2)),
                                 ("paper_cnn", (3, 80, 60), (1,))):
        for f in factors:
            d = pipeline.compile_model(getattr(frontend, name)(), [shape], factor=f)
            ops_by_name = {op.name: op for op in d.graph.ops}
            for op in d.graph.ops:
                if op.kind == "matmul":
                    (m, k), n = (ops_by_name[op.inputs[0]].shape,
                                 ops_by_name[op.inputs[1]].shape[1])
                    found.add((m, k, n, f, ops_by_name[op.inputs[1]].kind == "transpose"))
    assert sorted(found) == sorted(checks.MAIN_PATH_MATMULS)
    assert len(found) == 17
    for m, k, n, f, _ in found:
        p = bm.plan(m, n, k, bm.derive_block(m, n, k, (f, f, f)))
        assert p.skinny and p.splits == 1 and p.workspace == 0
        assert -(-p.ksplit // (32 * p.kw)) <= bm.MAX_K_PER_THREAD


def test_cnn_product_is_one_block_and_long_k_splits():
    """The CNN's (1, 5472) @ (5472, 2) is one block of 512 threads reading
    about 11 k values each; (1, 65536) @ (65536, 8) splits K over 4 blocks
    with a 4 x 1 x 8 f32 workspace and 32 k values a thread."""
    cnn = bm.plan(1, 2, 5472, bm.derive_block(1, 2, 5472, (1, 1, 1)))
    assert cnn.grid == (1, 1, 1) and cnn.threads == 512 and cnn.splits == 1
    assert 5 <= -(-cnn.ksplit // (32 * cnn.kw)) <= 11
    long_k = bm.plan(1, 8, 65536, bm.derive_block(1, 8, 65536, (1, 1, 1)))
    assert long_k.grid == (1, 1, 4) and long_k.workspace == 4 * 1 * 8
    assert -(-long_k.ksplit // (32 * long_k.kw)) == bm.MAX_K_PER_THREAD


@pytest.mark.parametrize("m,dtype,strides,aligned,want", [
    (8, torch.bfloat16, (64, 1, 1, 64), True, 0),        # skinny: no tiled kernel
    (32, torch.float32, (64, 1, 1, 64), True, 0),        # f32: the FMA kernel
    (32, torch.bfloat16, (64, 1, 1, 64), True, 1),       # B a transposed view
    (32, torch.bfloat16, (64, 1, 48, 1), True, 2),       # B row-major
    (32, torch.bfloat16, (33, 1, 9, 1), True, 0),        # rows off 16-byte bounds
    (32, torch.bfloat16, (64, 1, 48, 1), False, 0),      # a misaligned pointer
    (32, torch.bfloat16, (1, 64, 48, 1), True, 0),       # A a transposed view
])
def test_tensor_cores_take_aligned_bf16_tiles(m, dtype, strides, aligned, want):
    """The tiled variant runs bf16 on the tensor cores only where ``cp.async``
    can copy A's and B's rows 16 bytes at a time."""
    k, n = 64, 48
    block = bm.derive_block(m, n, k, (1, 1, 1))
    assert bm.tensor_cores(bm.plan(m, n, k, block), dtype, strides, block[1],
                           aligned) == want
