"""LM serving in the port: ``training.train_step``'s prefill and decode
steps against the JAX package's on the same weights and prompt, the
``serving`` re-exports, ``launch/serve.py`` on the CPU, and the card
checks of ``launch/lm_serve_checks.py`` rehearsed on the CPU at a SMOKE
size.

Tolerance: float32 logits at rtol = atol = 1e-4; the greedy tokens
exactly equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import transformer as JT
from repro.training import train_step as jsteps
from repro_torch import serving
from repro_torch.configs import registry
from repro_torch.launch import lm_serve_checks, serve
from repro_torch.models import transformer as T
from repro_torch.training import train_step as steps

F32 = dict(rtol=1e-4, atol=1e-4)


def test_serving_reexports_the_lm_surface():
    assert serving.cache_specs is T.cache_specs
    assert serving.cache_zeros is T.cache_zeros
    assert serving.make_prefill_step is steps.make_prefill_step
    assert serving.make_decode_step is steps.make_decode_step


def test_steps_match_jax():
    """Prefill a prompt of 12, then 6 greedy decode steps, each feeding
    back its own argmax, in both packages."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2.5-14b"),
                              dtype=torch.float32)
    jcfg = dataclasses.replace(rregistry.get_smoke_config("qwen2.5-14b"),
                               dtype=jnp.float32)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    p = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 12)).astype(
        np.int32)
    jlast, jcache = jax.jit(jsteps.make_prefill_step(jcfg, max_len=19))(
        jp, jnp.asarray(toks))
    last, cache = steps.make_prefill_step(cfg, max_len=19)(
        p, torch.from_numpy(toks))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **F32)
    assert cache["blocks"]["p0"]["k"].shape == (2, 3, 19, 2, 16)
    jdec, dec = jax.jit(jsteps.make_decode_step(jcfg)), \
        steps.make_decode_step(cfg)
    nxt = torch.argmax(last, -1)[:, None].to(torch.int32)
    jnxt = jnp.argmax(jlast, -1)[:, None].astype(jnp.int32)
    for _ in range(6):
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        tok, lg, cache = dec(p, cache, nxt)
        jtok, jlg, jcache = jdec(jp, jcache, jnxt)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **F32)
        assert tok.dtype == torch.int32 and tok.shape == (3,)
        nxt, jnxt = tok[:, None], jtok[:, None]
    assert int(cache["pos"]) == int(jcache["pos"]) == 18
    assert not last.requires_grad


def test_launcher_serves_a_smoke_config(capsys):
    rec = serve.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                      "--census"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen3-4b-smoke batch=4 prefill=")
    assert "decode=15 tok in" in out[0] and out[0].endswith("tok/s)")
    assert out[1].startswith("sampled ids: [")
    assert rec["device"] == "cpu" and rec["decode_steps"] == 15
    assert len(rec["decode_step_ms"]) == 15 and rec["prefill_s"] > 0
    assert rec["decode_ms_per_token"] > 0 and rec["tokens_per_s"] > 0
    assert rec["peak_allocated_bytes"] is None
    assert len(rec["sampled_ids"]) == 12
    assert all(0 <= t < 256 for t in rec["sampled_ids"])
    # a step of 2 layers: the census's ops, none a read of the device
    assert rec["decode_step_aten_ops"] > 50
    assert rec["decode_step_host_reads"] == 0
    again = serve.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu"])
    assert again["sampled_ids"] == rec["sampled_ids"]


def test_launcher_inputs_are_the_seeded_ones():
    cfg = registry.get_smoke_config("qwen1.5-4b")
    p, toks = serve.inputs(cfg, 2, 9, seed=4, device="cpu")
    p2, toks2 = serve.inputs(cfg, 2, 9, seed=4, device="cpu")
    assert toks.dtype == torch.int32 and toks.shape == (2, 9)
    assert torch.equal(toks, toks2)
    assert torch.equal(p["embed"], p2["embed"])
    # the weights come first from the generator, as init_params draws them
    assert torch.equal(p["embed"], T.init_params(cfg, 4, device="cpu")["embed"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b", "whisper-tiny",
                                  "llama-3.2-vision-90b"])
def test_launcher_refuses_item3_archs(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_launcher_default_arch_waits_for_item3():
    with pytest.raises(NotImplementedError, match="rwkv"):
        serve.main(["--smoke", "--device", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_launcher_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-4b", "--smoke"])


def test_card_checks_rehearse_on_the_cpu():
    """The ``lm_serve`` phase's four checks at the SMOKE size on the CPU:
    build, serve, float32 (through the flash branch, with ``attn_chunk``
    32 at a 64-token prompt) and a 2-layer cut run."""
    rows = []
    lm_serve_checks.run(rows.append, smoke=True, batch=2, prompt_len=64,
                        tokens=8, expect_params=90_496, device="cpu")
    assert [r["phase"] for r in rows] == ["lm_build", "lm_serve", "lm_fp32",
                                          "lm_card_vs_cpu"]
    assert rows[1]["decode_step_host_reads"] == 0
    assert rows[2]["decode_vs_teacher_forced_rel"] <= lm_serve_checks.REL_TOL
    cfg = dataclasses.replace(registry.get_smoke_config("qwen3-4b"),
                              attn_chunk=32, dtype=torch.float32)
    p, toks = serve.inputs(cfg, 2, 64, device="cpu")
    out = lm_serve_checks.hold_fp32(cfg, p, toks, 8)
    assert (out["prefill_branch"], out["teacher_forced_branch"]) == \
        ("flash", "naive")
    with pytest.raises(AssertionError, match="parameters"):
        lm_serve_checks.run(rows.append, smoke=True, batch=1, prompt_len=8,
                            tokens=2, expect_params=1, device="cpu")


def test_bounds_of_the_full_width_run():
    """qwen3-4b at B = 4: a decode step reads the 4,022,468,096 bf16
    weights and the K/V of 2064 positions; the prefill's operations are
    its matmuls, the causal half of its attention and the last
    position's head."""
    cfg = registry.get_config("qwen3-4b")
    b = lm_serve_checks.bounds(cfg, 4, 2048, 2064)
    kv = 36 * 2 * 4 * 2064 * 8 * 128
    assert b["decode_step_bytes"] == 2 * (4_022_468_096 + kv)
    assert b["decode_bound_ms"] == pytest.approx(
        1e3 * b["decode_step_bytes"] / 3.35e12)
    per_layer = 2560 * 4096 * 2 + 2 * 2560 * 1024 + 3 * 2560 * 9728
    flops = (2 * 4 * 2048 * per_layer * 36 + 2 * 4 * 32 * 2048 ** 2 * 128 * 36
             + 2 * 4 * 2560 * 151936)
    assert b["prefill_flops"] == flops
    assert b["prefill_bound_ms"] == pytest.approx(1e3 * flops / 989e12)
