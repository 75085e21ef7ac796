"""The port's synthetic data pipeline against the reference's, bit for bit.

``repro_torch.data.pipeline`` keeps the reference's counter-based draw, so
every batch (host-sharded ones included) and every modality equals
``repro.data.pipeline``'s.  A bfloat16 model's modality is a CPU
``torch.bfloat16`` tensor in the port (numpy has no bfloat16 without
``ml_dtypes``) with the bits of the reference's ``ml_dtypes`` array.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (registers ml_dtypes' bfloat16 with numpy)
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import get_config  # noqa: E402

MODALITY_ARCHS = ["whisper-large-v3", "llama-3.2-vision-11b"]


def _pair(vocab, seq, batch, host_id=0, host_count=1, arch=None,
          reduced=True, **kw):
    mc = rmc = None
    if arch is not None:
        mc, rmc = get_config(arch), ref_config(arch)
        if reduced:
            mc, rmc = mc.reduced(), rmc.reduced()
    port = SyntheticLM(DataConfig(vocab, seq, batch, **kw), host_id,
                       host_count, model_cfg=mc)
    ref = RSyntheticLM(RDataConfig(vocab, seq, batch, **kw), host_id,
                       host_count, model_cfg=rmc)
    return port, ref


def _bits(x) -> np.ndarray:
    """The raw bits of a bfloat16 array or tensor, as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("kw", [dict(), dict(seed=3), dict(zipf_a=1.1),
                                dict(bigram_frac=0.9)],
                         ids=["default", "seed3", "zipf1.1", "bigram0.9"])
@pytest.mark.parametrize("step", [0, 1, 7, 1000])
def test_batches_equal_the_reference(kw, step):
    port, ref = _pair(100, 16, 4, **kw)
    got, want = port.batch(step), ref.batch(step)
    assert set(got) == set(want) == {"tokens"}
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(port._succ, ref._succ)
    np.testing.assert_array_equal(port._p, ref._p)


@pytest.mark.parametrize("host_count", [2, 4])
def test_host_shards_equal_the_reference(host_count):
    shards = []
    for h in range(host_count):
        port, ref = _pair(100, 16, 8, host_id=h, host_count=host_count)
        got = port.batch(3)["tokens"]
        assert got.shape == (8 // host_count, 16)
        np.testing.assert_array_equal(got, ref.batch(3)["tokens"])
        shards.append(got)
    assert not np.array_equal(shards[0], shards[1])


def test_iterator_walks_the_steps():
    port, ref = _pair(64, 8, 2)
    for (i, got), want in zip(enumerate(port), ref):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["tokens"], port.batch(i)["tokens"])
        if i == 3:
            break


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_reduced_modality_equals_the_reference(arch):
    """float32 at the reduced configs: the same numpy array."""
    port, ref = _pair(256, 16, 2, arch=arch)
    got, want = port.batch(2), ref.batch(2)
    assert isinstance(got["modality"], np.ndarray)
    assert got["modality"].dtype == np.float32
    np.testing.assert_array_equal(got["modality"], want["modality"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", MODALITY_ARCHS)
def test_bf16_modality_has_the_reference_bits(arch):
    """The registered bfloat16 configs (1500 frames of 1280, 1601 patches of
    4096): float32 draws rounded to nearest even in both packages."""
    port, ref = _pair(256, 8, 1, arch=arch, reduced=False)
    got, want = port.batch(0)["modality"], ref.batch(0)["modality"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    assert str(want.dtype) == "bfloat16"
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_bf16_rounding_is_nearest_even_like_ml_dtypes():
    """Random bits, 196,608 consecutive values from 1 up, ties, signed zeros,
    subnormals and values that round up to infinity (NaN left out): torch's
    float32 -> bfloat16 cast is ml_dtypes'."""
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64),
        np.arange(0x3F800000, 0x3F800000 + 0x30000),
        [0x00000000, 0x80000000, 0x7F7FFFFF, 0x7F7F8000, 0x3F808000,
         0x3F818000, 0x00008000, 0x00018000]]).astype(np.uint32)
    f = bits.view(np.float32)
    f = f[~np.isnan(f)]
    want = f.astype("bfloat16")
    got = torch.from_numpy(f).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(got), _bits(want))
