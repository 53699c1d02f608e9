"""The tensor-parallel bf16 combine (``layers.tp_matmul_bf16reduce``'s
group branch, and ``mlp(..., bf16_reduce=True)`` on DTensors) on two
gloo ranks (``tests/torch_sharded_worker.py``, kinds ``tp`` and
``tp_dtensor``, a ``(data 1, model 2)`` mesh).

The reference's ``shard_map`` computes each device's partial ``x @ w``
over its ``F/tp`` slice, rounds it to bfloat16 and ``psum``s the rounded
values over ``model``.  Held here against that sum made by hand from the
same slices (inputs from a numpy seed).  Tolerance: equal bits."""
import numpy as np
import torch
import torch.nn.functional as F

from tests.test_torch_sharding import _spawn, _wait

TP = 2


def _inputs():
    rng = np.random.default_rng(3)
    return {"x": rng.standard_normal((4, 3, 16)).astype(np.float32),
            "w": rng.standard_normal((16, 8)).astype(np.float32),
            "w_gate": rng.standard_normal((8, 16)).astype(np.float32),
            "w_up": rng.standard_normal((8, 16)).astype(np.float32),
            "w_down": rng.standard_normal((16, 8)).astype(np.float32)}


def _bf16_sum(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p  # bfloat16 + bfloat16, rounded once, as the wire's
    return out


def test_bf16_combine_is_the_sum_of_rounded_partials(tmp_path):
    """Over a group of two the result is bfloat16 and equals, bit for bit,
    the sum of each rank's partial product rounded to bfloat16; so does
    the MLP's ``w_down`` product on DTensors sharded by the rules."""
    inp = _inputs()
    x = torch.from_numpy(inp["x"])
    np.savez(tmp_path / "tp_in.npz", x=inp["x"], w=inp["w"])
    np.savez(tmp_path / "tp_dt_in.npz", x=inp["x"][:, :, :8],
             **{k: inp[k] for k in ("w_gate", "w_up", "w_down")})
    cases = [dict(name="tp", kind="tp"),
             dict(name="tp_dt", kind="tp_dtensor")]
    _wait(_spawn(tmp_path, {"tag": "tp", "mesh": [1, TP],
                            "axes": ["data", "model"], "cases": cases}, TP))
    f = inp["w"].shape[0] // TP
    w = torch.from_numpy(inp["w"])
    want = _bf16_sum([(x[..., r * f:(r + 1) * f].contiguous()
                       @ w[r * f:(r + 1) * f].contiguous()).to(torch.bfloat16)
                      for r in range(TP)])
    got = dict(np.load(tmp_path / "tp_out.npz"))
    assert str(got["dtype"]) == "torch.bfloat16"
    np.testing.assert_array_equal(got["y"], want.float().numpy())
    # a float32 sum of the partials is another number: the rounding shows
    assert not np.array_equal(
        got["y"], (x @ w).to(torch.bfloat16).float().numpy())

    xd = torch.from_numpy(inp["x"][:, :, :8])
    wg, wu, wd = (torch.from_numpy(inp[k]) for k in
                  ("w_gate", "w_up", "w_down"))
    fh = wg.shape[1] // TP
    parts = []
    for r in range(TP):
        sl = slice(r * fh, (r + 1) * fh)
        h = F.silu(xd @ wg[:, sl].contiguous()) * (xd @ wu[:, sl].contiguous())
        parts.append((h @ wd[sl].contiguous()).to(torch.bfloat16))
    got = dict(np.load(tmp_path / "tp_dt_out.npz"))
    assert str(got["dtype"]) == "torch.bfloat16"
    assert "Replicate" in str(got["spec"])
    np.testing.assert_array_equal(got["y"], _bf16_sum(parts).float().numpy())
