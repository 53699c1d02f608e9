"""The port's training loop (``repro_torch.runtime.fault.run_loop``), its
elastic restore (``runtime/elastic.py``), the launcher
(``launch/train.py``) and ``examples/train_lm_torch.py``, on the CPU.

* A fault-injected run restarts once from its latest checkpoint and ends
  on the clean run's loss, bit for bit (the reference's
  ``test_recovery_is_deterministic`` asks 1e-5).
* The port's loop against the reference's ``run_loop`` on qwen3-4b SMOKE
  in float32, the same carried weights (``params_from_numpy``) and the
  same pipeline: the final loss within 1e-4 relative, and the loss after
  each committed checkpoint.
* ``rescale_checkpoint`` mirrors the reference's
  ``test_elastic_rescale_roundtrip``, on a checkpoint of either package.
* The launcher and the example run on the CPU; without a card and
  without ``--device cpu`` each fails rather than falling back."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro.configs import registry as rregistry
from repro.data import pipeline as JP
from repro.models import transformer as JT
from repro.runtime import fault as JF
from repro.training import optimizer as JO
from repro.training import train_step as JS
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs import registry
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer as T
from repro_torch.runtime import elastic as E
from repro_torch.runtime.fault import LoopReport, run_loop
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "PYTHONPATH": str(ROOT / "src")}
LOSS_TOL = 1e-4


def _port_loop(tmp_path, cfg, params_fn, *, total=12, fault_at=None,
               ckpt_every=4):
    """The reference test's ``_setup`` on the port: AdamW at 1e-3, a
    pipeline of 2 x 16 (seed 0), a checkpoint every ``ckpt_every``
    steps, one injected failure at ``fault_at``."""
    opt = O.make_optimizer("adamw", lr=1e-3)
    step = make_train_step(cfg, opt)

    def make_state():
        params = params_fn()
        return params, opt.init(params)

    def step_fn(params, opt_state, batch):
        return step(params, opt_state,
                    {k: torch.from_numpy(v) for k, v in batch.items()})

    fired = {"done": False}

    def hook(step_i):
        if fault_at is not None and step_i == fault_at and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("injected node failure")

    losses = []

    def logged(params, opt_state, batch):
        out = step_fn(params, opt_state, batch)
        losses.append(float(out[2]["loss"]))
        return out

    report = run_loop(ckpt_dir=str(tmp_path), total_steps=total,
                      make_state=make_state, step_fn=logged,
                      pipeline=TokenPipeline(cfg.vocab, 2, 16, seed=0),
                      ckpt_every=ckpt_every, fault_hook=hook, device="cpu")
    return report, losses


def _smoke():
    return registry.get_smoke_config("qwen3-4b")


def test_fault_injected_restart_completes(tmp_path):
    cfg = _smoke()
    report, _ = _port_loop(tmp_path, cfg,
                           lambda: T.init_params(cfg, 0, device="cpu"),
                           fault_at=6)
    assert isinstance(report, LoopReport)
    assert report.restarts == 1 and report.steps_done == 12
    assert C.latest_step(tmp_path) == 12


def test_recovery_is_deterministic(tmp_path):
    """Loss after a mid-run crash and restore equals the uninterrupted
    run's, bit for bit; the steps replayed after the restore give the
    clean run's losses."""
    cfg = _smoke()
    init = lambda: T.init_params(cfg, 0, device="cpu")  # noqa: E731
    clean, l_clean = _port_loop(tmp_path / "clean", cfg, init)
    fault, l_fault = _port_loop(tmp_path / "fault", cfg, init, fault_at=7)
    assert fault.restarts == 1
    assert fault.last_loss == clean.last_loss
    # steps 0-6, then (restored at 4) steps 4-11
    assert l_fault == l_clean[:7] + l_clean[4:]


def _jax_loop(tmp_path, jcfg, weights, total, ckpt_every):
    opt = JO.make_optimizer("adamw", lr=1e-3)
    step = jax.jit(JS.make_train_step(jcfg, opt))
    losses = []

    def make_state():
        params = jax.tree.map(jnp.asarray, weights)
        return params, opt.init(params)

    def logged(params, opt_state, batch):
        out = step(params, opt_state, batch)
        losses.append(float(out[2]["loss"]))
        return out

    report = JF.run_loop(ckpt_dir=str(tmp_path), total_steps=total,
                         make_state=make_state, step_fn=logged,
                         pipeline=JP.TokenPipeline(jcfg.vocab, 2, 16, seed=0),
                         ckpt_every=ckpt_every)
    return report, losses


def test_loop_matches_the_reference_run_loop(tmp_path):
    """qwen3-4b SMOKE in float32, the reference's weights carried across,
    8 steps with a checkpoint every 4: each step's loss and the final one
    within 1e-4 relative of the reference loop's; both wrote the same
    steps, and the port's last checkpoint restores in the reference with
    the reference's tree paths."""
    cfg = dataclasses.replace(_smoke(), dtype=torch.float32)
    jcfg = dataclasses.replace(rregistry.get_smoke_config("qwen3-4b"),
                               dtype=jnp.float32)
    w = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     JT.init_params(jcfg, jax.random.PRNGKey(0)))
    jrep, jl = _jax_loop(tmp_path / "jax", jcfg, w, 8, 4)
    rep, pl = _port_loop(tmp_path / "port", cfg,
                         lambda: T.params_from_numpy(cfg, w, device="cpu"),
                         total=8)
    assert rep.steps_done == jrep.steps_done == 8
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    np.testing.assert_allclose(rep.last_loss, jrep.last_loss, rtol=LOSS_TOL)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    ours, extra = JC.restore(tmp_path / "port")
    theirs, jextra = JC.restore(tmp_path / "jax")
    assert extra == jextra == {"step": 8, "pipeline": {"step": 8, "seed": 0}}
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_elastic_rescale_roundtrip(tmp_path, writer):
    """The reference's ``test_elastic_rescale_roundtrip``: a checkpoint of
    params and AdamW state (written by either package) restored by
    ``rescale_checkpoint`` onto the target device, every leaf there, the
    first leaf's values and the extra unchanged."""
    cfg = _smoke()
    jcfg = rregistry.get_smoke_config("qwen3-4b")
    extra = {"step": 7, "pipeline": {"step": 7, "seed": 0}}
    if writer == "port":
        params = T.init_params(cfg, 0, device="cpu")
        opt = O.make_optimizer("adamw")
        C.save(tmp_path, 7, {"params": params, "opt_state": opt.init(params)},
               extra=extra)
        first = T.tree_leaves(params)[0][1]
    else:
        params = JT.init_params(jcfg, jax.random.PRNGKey(0))
        opt = JO.make_optimizer("adamw")
        JC.save(tmp_path, 7, {"params": params,
                              "opt_state": opt.init(params)}, extra=extra)
        first = torch.from_numpy(np.asarray(
            jax.tree.leaves(params)[0]).astype(np.float32)).to(torch.bfloat16)
    p2, o2, got = E.rescale_checkpoint(tmp_path, cfg, "cpu")
    assert got["step"] == 7
    a = T.tree_leaves(p2)[0][1]
    assert a.dtype == torch.bfloat16
    assert torch.equal(a.view(torch.int16), first.view(torch.int16))
    assert all(t.device.type == "cpu" for _, t in T.tree_leaves(
        {"p": p2, "o": o2}))
    assert o2["count"].dtype == torch.int32 and int(o2["count"]) == 0
    sh = E.shardings_for(cfg, "cpu")
    assert {p for p, _ in T.tree_leaves(sh["params"])} == {
        p for p, _ in T.tree_leaves(p2)}
    assert E.rescale_checkpoint(tmp_path / "none", cfg, "cpu") == (
        None, None, None)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """``launch.train --smoke --device cpu``: the reference's summary
    line, a record; a second run on the same directory resumes (no step
    left to take)."""
    from repro_torch.launch import train

    argv = ["--smoke", "--device", "cpu", "--steps", "4", "--ckpt-every",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    rec = train.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("arch=qwen3-4b-smoke params~") and "steps=4" in line
    assert rec["device"] == "cpu" and rec["steps_done"] == 4
    assert np.isfinite(rec["last_loss"]) and len(rec["step_s"]) == 4
    assert C.latest_step(tmp_path) == 4
    again = train.main(argv)
    assert again["steps_done"] == 0 and again["step_s"] == []


def test_launcher_options_on_the_cpu(tmp_path):
    """jamba SMOKE (Adafactor) with two microbatches and compressed
    gradients, and qwen3-4b cut to 1 layer."""
    from repro_torch.launch import train

    rec = train.main(["--arch", "jamba-1.5-large-398b", "--smoke",
                      "--device", "cpu", "--steps", "2", "--seq", "32",
                      "--microbatches", "2", "--compress-grads",
                      "--ckpt-dir", str(tmp_path / "j")])
    assert rec["optimizer"] == "adafactor" and rec["steps_done"] == 2
    assert np.isfinite(rec["last_loss"])
    rec = train.main(["--smoke", "--layers", "1", "--device", "cpu",
                      "--steps", "1", "--seq", "16",
                      "--ckpt-dir", str(tmp_path / "q")])
    assert rec["n_layers"] == 1 and rec["steps_done"] == 1


def _example(*args):
    return subprocess.run([sys.executable,
                           str(ROOT / "examples" / "train_lm_torch.py"),
                           *args], env=ENV, cwd=ROOT, capture_output=True,
                          text=True, timeout=120)


def test_train_example_runs_on_the_cpu():
    r = _example("--device", "cpu", "--steps", "12")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1].startswith("verified: ") and "on cpu" in lines[-1]


def test_train_example_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable")
    r = _example("--steps", "2")
    assert r.returncode != 0
    assert "no CUDA device is visible" in r.stderr
    assert "verified" not in r.stdout


def test_train_checks_rehearse_on_the_cpu():
    """``chip_smoke.py``'s ``train`` phase at the SMOKE configs on the
    CPU: every row trains (the loss falls, no host read in a step, the
    bound's parts from the shapes), the card-vs-CPU check runs (the CPU
    twice: exact), and the restart ends on the clean loss."""
    from repro_torch.launch import train_checks as TC

    rows = []
    TC.run(rows.append, smoke=True, device="cpu")
    trained = [r for r in rows if r["phase"] == "train"]
    assert [r["row"] for r in trained] == list(TC.ROWS)
    for r in trained:
        assert r["step_host_reads"] == 0 and r["step_aten_ops"] > 0
        assert r["losses"][-1] < r["losses"][0]
        assert r["step_bound_ms"] == pytest.approx(
            r["flops_bound_ms"] + r["optimizer_bound_ms"])
        # 8 N T, N the parameters a token multiplies by
        dense = 8 * r["params"] * TC.BATCH * TC.SEQ
        moe = "moe" in r["pattern"][0]
        assert (r["step_flops"] < dense) if moe else (
            r["step_flops"] == dense)
    assert trained[2]["metrics"]["aux"] > 0  # mixtral's MoE layer
    (cvc,) = [r for r in rows if r["phase"] == "train_card_vs_cpu"]
    assert cvc["loss_rel_err"] == 0 and cvc["update_rel_err"] == 0
    (rs,) = [r for r in rows if r["phase"] == "train_restart"]
    assert rs["restarts"] == 1 and rs["clean_loss"] == rs["restarted_loss"]
    assert rs["checkpoints"] == ["step_00000002", "step_00000003"]
