"""The port's checkpoint manager against the reference's, on the CPU.

The reference's four cases (``tests/test_substrate.py::TestCheckpoint``)
on the port; the same files: a train state ``{"params", "opt": OptState}``
written by either package has the same npz members, byte for byte (keys
``opt/.step``, ``opt/.m/<path>``, ``opt/.v/<path>``, ``params/<path>``;
bfloat16 leaves as ``'<V2'``), and the same manifest but for its time;
a float32 checkpoint restores in the other package with equal bits, both
ways; and ``ROADMAP.md`` C.19, a bfloat16 leaf that neither package can
restore, pinned on both sides.
"""
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as RManager  # noqa: E402
from repro.checkpoint.manager import _flatten as ref_flatten  # noqa: E402
from repro.models import get_config as ref_config  # noqa: E402
from repro.models import params as RP  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro_torch.checkpoint import manager as M  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.runtime.trainer import state_from_numpy  # noqa: E402


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _states(dtype: str, step: int = 3):
    """The reference's and the port's train state of the reduced qwen2-0.5b
    in ``dtype``: seed-0 params, seeded moments, the same values."""
    rcfg = ref_config("qwen2-0.5b").reduced()
    p = jax.tree.map(_np, RP.init_params(rcfg, seed=0))
    rng = np.random.default_rng(5)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), p)
    v = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), p)
    ref = {"params": jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), p),
           "opt": RA.OptState(jnp.asarray(step, jnp.int32),
                              jax.tree.map(jnp.asarray, m),
                              jax.tree.map(jnp.asarray, v))}
    port = state_from_numpy({"params": p, "opt": (step, m, v)}, "cpu",
                            getattr(torch, dtype))
    return ref, port


def _members(path):
    with zipfile.ZipFile(path / "arrays.npz") as z:
        return {n: z.read(n) for n in z.namelist()}, z.namelist()


def _manifest(path):
    m = json.loads((path / "manifest.json").read_text())
    assert isinstance(m.pop("time"), float)
    return m


# -- the reference's four cases ------------------------------------------------


def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "nested": {"b": torch.ones(4, dtype=torch.int32)}}
    m.save(5, state)
    restored, step = m.restore(state)
    assert step == 5
    for got, want in ((restored["a"], state["a"]),
                      (restored["nested"]["b"], state["nested"]["b"])):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_retention(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        m.save(s, {"a": torch.zeros(2)})
    assert m.all_steps() == [3, 4]


def test_incomplete_checkpoint_ignored(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(1, {"a": torch.zeros(2)})
    broken = tmp_path / "step_00000002"
    broken.mkdir()
    (broken / "arrays.npz").write_bytes(b"garbage")
    assert m.latest_step() == 1
    bad_manifest = tmp_path / "step_00000003"
    bad_manifest.mkdir()
    (bad_manifest / "manifest.json").write_text("{not json")
    assert m.latest_step() == 1


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True)
    m.save(7, {"a": torch.ones(8)})
    m.wait()
    assert m.latest_step() == 7


# -- the port's own contract ---------------------------------------------------


def test_async_save_copies_before_returning(tmp_path):
    """A state updated in place after ``save`` returns is saved as it was
    when ``save`` was called (the host copies come first)."""
    m = CheckpointManager(str(tmp_path), async_save=True)
    state = {"a": torch.ones(1 << 16), "b": torch.ones(4, dtype=torch.bfloat16)}
    m.save(1, state)
    for t in state.values():
        t.mul_(3)
    m.wait()
    back, _ = m.restore({"a": torch.zeros(1 << 16)})
    assert torch.equal(back["a"], torch.ones(1 << 16))
    assert _manifest(tmp_path / "step_00000001")["dtypes"] == {
        "a": "float32", "b": "bfloat16"}


def test_keys_follow_the_reference_flattening():
    state = {"z": [torch.zeros(1), (torch.zeros(1),)],
             "opt": A.OptState(torch.zeros(()), {"w": torch.zeros(1)},
                               {"w": torch.zeros(1)}),
             "params": {"b": {"y": torch.zeros(1), "x": torch.zeros(1)}}}
    ref_state = jax.tree.map(lambda t: jnp.zeros(t.shape),
                             {**state, "opt": RA.OptState(*state["opt"])})
    keys = [k for k, _ in M._flatten(state)]
    assert keys == ["opt/.step", "opt/.m/w", "opt/.v/w", "params/b/x",
                    "params/b/y", "z/0", "z/1/0"]
    assert keys == [k for k, _ in ref_flatten(ref_state)[0]]
    back = M._unflatten(state, iter(range(len(keys))))
    assert back["z"] == [5, (6,)] and back["opt"].step == 0
    assert isinstance(back["opt"], A.OptState)


def test_restore_takes_the_device_and_dtype_of_like(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(2, {"a": torch.linspace(-1, 1, 7)})
    like = {"a": torch.zeros(7, dtype=torch.bfloat16)}
    back, _ = m.restore(like)
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], torch.linspace(-1, 1, 7).to(torch.bfloat16))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(like)


# -- against the reference -----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_files_equal_the_reference(tmp_path, dtype):
    ref, port = _states(dtype)
    RManager(str(tmp_path / "r"), async_save=False).save(3, ref)
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(3, port)
    rdir, pdir = tmp_path / "r" / "step_00000003", tmp_path / "p" / "step_00000003"
    (rbytes, rnames), (pbytes, pnames) = _members(rdir), _members(pdir)
    assert pnames == rnames
    assert pnames[:2] == ["opt/.step.npy", "opt/.m/blocks/lyr/attn/bk.npy"]
    assert pbytes == rbytes
    assert _manifest(pdir) == _manifest(rdir)
    if dtype == "bfloat16":
        head = pbytes["params/embed.npy"][:80]
        assert b"'descr': '<V2'" in head
        assert _manifest(pdir)["dtypes"]["params/embed"] == "bfloat16"


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref, port = _states("float32", step=6)
    CheckpointManager(str(tmp_path), async_save=False).save(6, port)
    like = jax.tree.map(jnp.zeros_like, ref)
    back, step = RManager(str(tmp_path)).restore(like)
    assert step == 6
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref, port = _states("float32", step=6)
    RManager(str(tmp_path), async_save=False).save(6, ref)
    like = {"params": A.tree_map(torch.zeros_like, port["params"]),
            "opt": A.init_state(port["params"])}
    back, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 6 and int(back["opt"].step) == 6
    assert back["opt"].step.dtype == torch.int32
    for a, b in zip(A.leaves(back["params"]) + A.leaves(back["opt"].m),
                    A.leaves(port["params"]) + A.leaves(port["opt"].m)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_c19_bf16_checkpoints_restore_in_neither_package(tmp_path):
    """ROADMAP.md C.19: a bfloat16 leaf is written as ``'<V2'``, and
    restoring it into a bfloat16 prototype raises ``ValueError`` in the
    reference (numpy has no cast from the void type) and in the port,
    whichever package wrote it."""
    ref, port = _states("bfloat16")
    RManager(str(tmp_path / "r"), async_save=False).save(3, ref)
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(3, port)
    for d in ("r", "p"):
        with pytest.raises(ValueError, match="No cast function available"):
            RManager(str(tmp_path / d)).restore(ref)
        with pytest.raises(ValueError, match="No cast function available"):
            CheckpointManager(str(tmp_path / d)).restore(port)
