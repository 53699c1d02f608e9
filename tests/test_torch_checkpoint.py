"""The port's checkpoints (``repro_torch.checkpoint.checkpoint``) against
the JAX package's on the CPU, in both directions: a checkpoint either
package writes restores in the other with the same bits (bfloat16,
float32, int32 and int8 leaves, nested trees, 0-d leaves), through the
manifest's dtypes (a bfloat16 leaf is stored as its uint16 bits, read
back through ``torch.int16``); ``latest_step``, ``prune``, the atomic
commit and an empty directory behave as the reference's; placement by
``device``; a dtype numpy cannot hold is refused."""
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro_torch.checkpoint import checkpoint as C
from repro_torch.models import transformer as T


def _tree(seed=0):
    """numpy leaves: bf16 (as ml_dtypes for JAX), float32, int32 (0-d
    too), int8, nested two deep, and a list."""
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((5, 7)).astype(np.float32)
    bf[0, :4] = [np.inf, -0.0, 1e-40, 3.0e38]  # inf, -0, subnormal, big
    return {"w": bf.astype(ml_dtypes.bfloat16),
            "nested": {"b": rng.standard_normal(6).astype(np.float32),
                       "deeper": {"count": np.asarray(7, np.int32),
                                  "ids": rng.integers(-9, 9, (3, 2)).astype(
                                      np.int32)}},
            "q": rng.integers(-127, 128, (4,)).astype(np.int8),
            "pair": [np.arange(3, dtype=np.float32),
                     np.ones((2, 2), np.int32)]}


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return C._flatten(tree)


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a).tobytes()


def _port_tree(tree):
    out = {}
    for k, v in _flat(tree).items():
        out[k] = _to_torch(v)
    return C._unflatten(out)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """Written by the reference (its jnp arrays), restored by the port on
    the CPU: every leaf's dtype, shape and bits, and the extra."""
    tree = _tree()
    jtree = {k: v for k, v in tree.items()}
    jtree["w"] = jnp.asarray(tree["w"])
    JC.save(tmp_path, 3, jtree, extra={"step": 3, "pipeline": {"step": 3}})
    got, extra = C.restore(tmp_path, device="cpu")
    assert extra == {"step": 3, "pipeline": {"step": 3}}
    want = _flat(tree)
    flat = _flat(got)
    assert flat.keys() == want.keys()
    for k, v in want.items():
        t = flat[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert tuple(t.shape) == v.shape
        assert t.dtype == _to_torch(v).dtype, k
        assert _bits(t) == _bits(v), k


def test_port_checkpoint_restores_in_jax(tmp_path):
    """Written by the port from torch tensors, restored by the reference
    (``ml_dtypes`` views): equal bits, the manifest's dtypes the
    reference's names."""
    tree = _tree(1)
    C.save(tmp_path, 5, _port_tree(tree), extra={"step": 5})
    manifest = json.loads((tmp_path / "step_00000005" /
                           "manifest.json").read_text())
    assert manifest["dtypes"]["w"] == "bfloat16"
    assert manifest["dtypes"]["nested/deeper/count"] == "int32"
    got, extra = JC.restore(tmp_path)
    assert extra == {"step": 5}
    want = _flat(tree)
    flat = _flat(got)
    assert flat.keys() == want.keys()
    for k, v in want.items():
        assert np.asarray(flat[k]).dtype == v.dtype, k
        assert _bits(flat[k]) == _bits(v), k


def test_round_trip_through_both_packages(tmp_path):
    """port -> JAX -> port: the bits survive both directions."""
    tree = _port_tree(_tree(2))
    C.save(tmp_path / "a", 1, tree)
    mid, _ = JC.restore(tmp_path / "a")
    JC.save(tmp_path / "b", 1, mid)
    back, _ = C.restore(tmp_path / "b", device="cpu")
    for k, v in _flat(tree).items():
        assert _bits(_flat(back)[k]) == _bits(v), k


def test_latest_and_prune(tmp_path):
    """The reference's test on the port, and the same directory read by
    the reference's ``latest_step``."""
    for s in (1, 2, 3, 4, 5):
        C.save(tmp_path, s, {"x": torch.zeros(1)}, extra={})
    assert C.latest_step(tmp_path) == 5
    C.prune(tmp_path, keep=2)
    assert C.latest_step(tmp_path) == JC.latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000005"]
    got, _ = C.restore(tmp_path, step=5, device="cpu")
    assert got is not None


def test_restore_empty_dir(tmp_path):
    """No checkpoint: ``(None, None)``, on any device (the card is not
    asked for)."""
    assert C.restore(tmp_path / "nothing") == (None, None)
    assert C.latest_step(tmp_path / "nothing") is None


def test_uncommitted_tmp_is_ignored(tmp_path):
    """A save that died before its rename leaves ``step_<n>.tmp``: the
    latest committed step is restored; a new save of that step replaces
    the leftover."""
    C.save(tmp_path, 2, {"x": torch.ones(2)})
    (tmp_path / "step_00000003.tmp").mkdir()
    assert C.latest_step(tmp_path) == 2
    got, _ = C.restore(tmp_path, device="cpu")
    assert torch.equal(got["x"], torch.ones(2))
    C.save(tmp_path, 3, {"x": torch.zeros(2)})
    assert not (tmp_path / "step_00000003.tmp").exists()
    assert C.latest_step(tmp_path) == 3


def test_restore_places_leaves(tmp_path):
    """``device`` places every leaf, nested ones too.  Without a card the
    default device is refused, not swapped for the CPU."""
    C.save(tmp_path, 1, {"w": torch.arange(8.0), "o": {"c": torch.ones(2)}})
    got, _ = C.restore(tmp_path, device="cpu")
    assert all(t.device.type == "cpu" for _, t in T.tree_leaves(got))
    assert torch.equal(got["w"], torch.arange(8.0))
    assert torch.equal(got["o"]["c"], torch.ones(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            C.restore(tmp_path)


def test_unsupported_dtype_is_refused(tmp_path):
    """A dtype numpy cannot hold, other than bfloat16, raises: it is never
    written narrowed; nothing is committed."""
    with pytest.raises(TypeError, match="cannot checkpoint"):
        C.save(tmp_path, 1, {"x": torch.zeros(3, dtype=torch.float8_e4m3fn)})
    assert C.latest_step(tmp_path) is None
