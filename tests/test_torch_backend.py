"""The torch oracle against the jnp oracle, on the CPU.

Each graph is traced by both packages from the same seed and fed the same
numpy input; tolerance rtol = atol = 2e-5 (float32, sums taken in another
order by XLA and by PyTorch's CPU kernels).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import frontend as ref_frontend  # noqa: E402
from repro.core import jax_backend  # noqa: E402
from repro.core import tensor_ir as ref_T  # noqa: E402
from repro_torch.core import frontend, pipeline, torch_backend  # noqa: E402
from repro_torch.core import tensor_ir as T  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _causal_scores(fe, tir):
    class M(fe.Module):
        def forward(self, x):
            g = x.graph
            s = x @ x.t()
            return fe.Value(g, tir.causal_mask(g, s.name))
    return M()


def _matmul(fe, tir):
    class M(fe.Module):
        def __init__(self):
            self.lin = fe.Linear(6, 5, bias=False)

        def forward(self, x):
            return self.lin(x)
    return M()


# model builders (given a frontend and its tensor_ir) and input shapes: the
# paper's models and the graphs of tests/test_core_affine.py
GRAPHS = {
    "paper_ffnn": (lambda fe, tir: fe.paper_ffnn(), (1, 64)),
    "paper_cnn": (lambda fe, tir: fe.paper_cnn(), (3, 80, 60)),
    "paper_mha": (lambda fe, tir: fe.paper_mha(), (8, 42)),
    "matmul": (_matmul, (3, 6)),
    "linear_bias_relu": (lambda fe, tir: fe.Sequential(fe.Linear(6, 4), fe.ReLU()),
                         (2, 6)),
    "conv_pool_flatten": (lambda fe, tir: fe.Sequential(
        fe.Conv2d(2, 3, 3, 3), fe.MaxPool2d(2, 2), fe.Flatten()), (2, 7, 7)),
    "softmax": (lambda fe, tir: fe.Softmax(), (3, 5)),
    "causal_mask_and_transpose": (_causal_scores, (4, 3)),
    "mha_4x42": (lambda fe, tir: fe.paper_mha(), (4, 42)),
}


def _graphs(name):
    build, shape = GRAPHS[name]
    port = frontend.trace(build(frontend, T), [shape])
    ref = ref_frontend.trace(build(ref_frontend, ref_T), [shape])
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    return port, ref, {"arg0": x}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_oracle_matches_jnp_oracle(name):
    port, ref, x = _graphs(name)
    got = torch_backend.execute_graph(port, x, device="cpu")
    want = jax_backend.execute_graph(ref, x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TOL)


def test_carried_weights_compute_what_the_reference_computes():
    """The reference graph's params, carried across, replace the port's own
    (drawn here from another seed)."""
    ref = ref_frontend.trace(ref_frontend.paper_ffnn(rng_seed=0), [(1, 64)])
    port = frontend.trace(frontend.paper_ffnn(rng_seed=1), [(1, 64)])
    x = {"arg0": np.random.default_rng(3).normal(size=(1, 64)).astype(np.float32)}
    weights = torch_backend.params_to_torch(ref.params, "cpu", port)
    assert all(w.dtype == torch.float32 and w.device.type == "cpu"
               for w in weights.values())
    mod = torch_backend.as_torch_fn(port, "cpu", params=ref.params)
    (got,) = mod(x)
    (want,) = jax_backend.execute_graph(ref, x)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    (own,) = torch_backend.execute_graph(port, x, device="cpu")
    assert not np.allclose(own, want)


def test_carried_weights_are_checked():
    ref = ref_frontend.trace(ref_frontend.paper_ffnn(), [(1, 64)])
    port = frontend.trace(frontend.paper_ffnn(), [(1, 64)])
    missing = dict(ref.params)
    missing.pop(sorted(missing)[0])
    with pytest.raises(ValueError, match="takes params"):
        torch_backend.params_to_torch(missing, "cpu", port)
    name = sorted(ref.params)[0]
    bad = {**ref.params, name: np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        torch_backend.as_torch_fn(port, "cpu", params=bad)


def test_run_oracle_without_a_card_raises(monkeypatch):
    """No device given means cuda; with no card it raises, never falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = pipeline.compile_model(frontend.paper_ffnn(), [(1, 64)])
    x = {"arg0": np.zeros((1, 64), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        d.run_oracle(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_backend.execute_graph(d.graph, x, device="cuda")
    np.testing.assert_allclose(d.run_oracle(x, device="cpu")[0], d.run(x)[0],
                               rtol=1e-4, atol=1e-5)
