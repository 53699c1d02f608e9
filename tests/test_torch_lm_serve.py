"""LM serving in the port: ``training.train_step``'s prefill and decode
steps against the JAX package's on the same weights and prompt, the
``serving`` re-exports, ``launch/serve.py`` on the CPU (every family),
and the card checks of ``launch/lm_serve_checks.py`` (every family's
row, jamba's Mamba layer, the bounds) rehearsed on the CPU at a SMOKE
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
from repro_torch.models import layers as L
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
    p, toks, ext = serve.inputs(cfg, 2, 9, seed=4, device="cpu")
    p2, toks2, _ = serve.inputs(cfg, 2, 9, seed=4, device="cpu")
    assert toks.dtype == torch.int32 and toks.shape == (2, 9)
    assert torch.equal(toks, toks2)
    assert torch.equal(p["embed"], p2["embed"])
    assert ext is None  # a text-only arch
    # the weights come first from the generator, as init_params draws them
    assert torch.equal(p["embed"], T.init_params(cfg, 4, device="cpu")["embed"])


@pytest.mark.parametrize("arch,n", [("whisper-tiny", "enc_len"),
                                    ("llama-3.2-vision-90b", "img_tokens")])
def test_launcher_draws_the_external_embeddings(arch, n):
    """Audio frames or image patches (B, n, D), standard normal in the
    model's dtype, drawn after the tokens from the same generator."""
    cfg = registry.get_smoke_config(arch)
    p, toks, ext = serve.inputs(cfg, 3, 8, seed=2, device="cpu")
    assert ext.shape == (3, getattr(cfg, n), cfg.d_model)
    assert ext.dtype == cfg.dtype
    gen = torch.Generator().manual_seed(2)
    T.init_params(cfg, gen, device="cpu")
    torch.randint(0, cfg.vocab, (3, 8), generator=gen, dtype=torch.int32)
    assert torch.equal(ext, serve.ext_embed(cfg, 3, gen, torch.device("cpu")))
    big = serve.ext_embed(cfg, 64, torch.Generator().manual_seed(0),
                          torch.device("cpu")).float()
    assert abs(big.mean().item()) < 0.05 and abs(big.std().item() - 1) < 0.05


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b", "whisper-tiny",
                                  "llama-3.2-vision-90b"])
def test_launcher_refuses_item3_archs(arch, capsys):
    """Once refused (they waited for the other mixers, Queue 1 item 3):
    each family now serves at SMOKE size on the CPU, with no host read in
    a decode step, as deterministically as the dense ones."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--tokens", "6"]
    rec = serve.main(argv + ["--census"])
    cfg = registry.get_smoke_config(arch)
    assert capsys.readouterr().out.startswith(f"arch={cfg.name} batch=2 ")
    assert rec["decode_steps"] == 5 and rec["decode_step_host_reads"] == 0
    assert rec["params"] == T.param_count(T.init_params(cfg, 0,
                                                        device="cpu"))
    assert all(0 <= t < cfg.vocab for t in rec["sampled_ids"])
    assert serve.main(argv)["sampled_ids"] == rec["sampled_ids"]


def test_launcher_default_arch_waits_for_item3(capsys):
    """The default arch, rwkv6-1.6b (the reference's default too), serves;
    ``--layers`` cuts its depth."""
    rec = serve.main(["--smoke", "--device", "cpu"])
    assert rec["arch"] == "rwkv6-1.6b-smoke" and rec["n_layers"] == 2
    assert "arch=rwkv6-1.6b-smoke" in capsys.readouterr().out
    one = serve.main(["--smoke", "--device", "cpu", "--layers", "1"])
    assert one["n_layers"] == 1 and one["params"] < rec["params"]


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
    p, toks, _ = serve.inputs(cfg, 2, 64, device="cpu")
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


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-tiny",
                                  "mixtral-8x7b", "llama-3.2-vision-90b"])
def test_card_checks_rehearse_every_family_on_the_cpu(arch):
    """Each new row of the ``lm_serve`` phase at its SMOKE size on the CPU,
    with the row's own cuts (mixtral's float32 hold on a 1-layer cut,
    llama-vision's card-vs-CPU on its ``cross+mlp`` layer alone)."""
    row = dict(lm_serve_checks.ROWS[arch])
    row.pop("expect_params")
    row.update(prompt_len=64, tokens=64 if arch == "rwkv6-1.6b" else 8,
               layers=None)
    if "fp32_layers" in row:
        row["fp32_layers"] = {"mixtral-8x7b": 1,
                              "llama-3.2-vision-90b": 5}[arch]
    if row.get("cut_layers") == 4:
        row["cut_layers"] = 2
    rows = []
    lm_serve_checks.run(rows.append, arch=arch, smoke=True, batch=2,
                        device="cpu", **row)
    assert [r["phase"] for r in rows] == ["lm_build", "lm_serve", "lm_fp32",
                                          "lm_card_vs_cpu"]
    serve_row, fp32, vs = rows[1], rows[2], rows[3]
    assert serve_row["decode_step_host_reads"] == 0
    assert serve_row["params"] == rows[0]["params"]
    assert fp32["decode_vs_teacher_forced_rel"] <= lm_serve_checks.REL_TOL
    assert fp32["prefill_vs_train_rel"] <= lm_serve_checks.REL_TOL
    if arch == "mixtral-8x7b":
        assert fp32["n_layers"] == 1 and fp32["chain_capacity_factor"] == 4
    if arch == "llama-3.2-vision-90b":
        assert vs["pattern"] == ["cross+mlp"] and vs["layers"] == 1
    assert vs["rel_err"] == 0.0  # the CPU twice


def test_mamba_layer_checks_rehearse_on_the_cpu():
    """Jamba's ``mamba+mlp`` layer at SMOKE width (prefill, 64 decode
    steps, the float32 holds, the CPU twice), then its SMOKE config served
    whole; a wrong parameter count is refused."""
    rows = []
    lm_serve_checks.mamba_layer(rows.append, smoke=True, batch=2,
                                prompt_len=64, tokens=64, device="cpu")
    assert [r["phase"] for r in rows] == [
        "lm_build", "lm_serve", "lm_fp32", "lm_card_vs_cpu", "lm_serve",
        "lm_card_vs_cpu"]
    cfg = registry.get_smoke_config("jamba-1.5-large-398b")
    assert rows[0]["params"] == T.param_count(dict(T.tree_leaves(
        T.init_params(dataclasses.replace(
            cfg, block_pattern=("mamba+mlp",), n_layers=1), 0,
            device="cpu")["blocks"])))
    assert rows[1]["decode_step_host_reads"] == 0
    assert rows[1]["decode_steps"] == 64
    assert rows[2]["decode_vs_teacher_forced_rel"] <= lm_serve_checks.REL_TOL
    assert rows[2]["teacher_forced_len"] == 128
    assert rows[4]["arch"] == "jamba-1.5-large-398b-smoke"
    assert rows[4]["decode_step_host_reads"] == 0
    with pytest.raises(AssertionError, match="parameters"):
        lm_serve_checks.mamba_layer(rows.append, smoke=True, batch=1,
                                    prompt_len=8, tokens=0, expect_params=1,
                                    device="cpu")


def test_bounds_of_every_family():
    """The bounds count each family's own work: MoE the top_k experts a
    token goes to (and a decode step only the experts B * top_k tokens
    can touch), the recurrent states read and written in their dtypes
    (float32 ``ssm``/``wkv``), no attention square where there is none,
    and the external K/V projections, cross scores and the encoder's
    bidirectional squares."""
    mix = registry.get_config("mixtral-8x7b")
    d, f = 4096, 14336
    one = lm_serve_checks.layer_flops(mix, "attn+moe", 4, 2048)
    dense = lm_serve_checks.layer_flops(
        dataclasses.replace(mix, n_experts=0), "attn+mlp", 4, 2048)
    t = 4 * 2048
    assert one - dense == 2 * t * (d * 8 + 2 * 3 * d * f) - 2 * t * 3 * d * f
    b1 = lm_serve_checks.bounds(dataclasses.replace(mix, n_layers=2), 1,
                                64, 64)
    b4 = lm_serve_checks.bounds(dataclasses.replace(mix, n_layers=2), 4,
                                64, 64)
    # B = 1 touches 2 of 8 experts a layer; B = 4 all 8
    assert b4["decode_weight_bytes"] - b1["decode_weight_bytes"] == \
        2 * 2 * 6 * 3 * d * f
    rw = registry.get_config("rwkv6-1.6b")
    b = lm_serve_checks.bounds(rw, 4, 2048, 2080)
    wkv = 24 * 4 * 32 * 64 * 64 * 4  # float32
    xs = 2 * 24 * 4 * 2048 * 2  # tm_x and cm_x, bf16
    assert b["decode_cache_bytes"] == 2 * (wkv + xs)
    assert b["decode_weight_bytes"] == 2 * 1_449_723_904
    wh = registry.get_config("whisper-tiny")
    bw = lm_serve_checks.bounds(wh, 4, 384, 416)
    enc = 4 * (lm_serve_checks.layer_flops(wh, "attn+mlp", 4, 1500)
               + 4 * 4 * 6 * 64 * 1500 ** 2 / 2)
    dec = 4 * lm_serve_checks.layer_flops(wh, "attn_cross+mlp", 4, 384, 1500)
    assert bw["prefill_flops"] == enc + dec + 2 * 4 * 384 * 51865
    specs = T.tree_leaves(T.param_specs(wh), lambda x: isinstance(x, L.PSpec))
    n_dec = sum(int(np.prod(s.shape)) for p, s in specs
                if not p.startswith("encoder."))
    assert bw["decode_weight_bytes"] == 2 * n_dec < 2 * 41_159_808


@pytest.mark.parametrize("arch", ["whisper-tiny", "mixtral-8x7b",
                                  "jamba-1.5-large-398b"])
def test_unit_gain_draws_each_layer_at_its_own_width(arch):
    """Every normal block leaf rescaled to ``1 / sqrt(fan_in)`` of the
    width it contracts over (an expert's input, ``wo``'s heads x head dim,
    else the first dim); the embedding, the norms and the zero / one
    leaves untouched."""
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype=torch.float32)
    p = T.init_params(cfg, 3, device="cpu")
    before = {k: v.clone() for k, v in T.tree_leaves(p)}
    lm_serve_checks.unit_gain(cfg, p)
    specs = dict(T.tree_leaves(T.param_specs(cfg),
                               lambda x: isinstance(x, L.PSpec)))
    for path, t in T.tree_leaves(p):
        spec = specs[path]
        if spec.init != "normal" or not path.startswith(
                ("blocks.", "encoder.blocks.")):
            assert torch.equal(t, before[path]), path
            continue
        shape = spec.shape[1:]
        fan = (shape[1] if ".moe." in path and len(shape) == 3 else
               shape[0] * shape[1] if path.endswith(".wo") else shape[0])
        # the same draw, rescaled
        ratio = (t / before[path]).flatten()
        assert torch.allclose(ratio, ratio[0].expand_as(ratio)), path
        assert t.std().item() == pytest.approx(1 / np.sqrt(fan), rel=0.1), \
            path
