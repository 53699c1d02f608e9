"""GPipe over ``torch.distributed`` (``repro_torch.training.pipeline_pp``)
against the JAX package's single-program loss and gradients, as
``tests/test_pipeline_pp.py`` holds the reference's GPipe.

Two gloo ranks are the two stages (``tests/torch_sharded_worker.py``,
kind ``pp``): qwen3-4b SMOKE at 4 layers in float32, batch 4 x 16 from a
numpy seed, 2 microbatches, on the reference's weights (its float32
init, key 0).  The reference's ``make_loss_fn`` and ``jax.grad`` run
here meanwhile.  The stages' block gradients are concatenated; the
embedding's and the final norm's are summed over the stages by the port.

Tolerances: the reference test's own, the loss within 1e-4 (relative
and absolute) and each gradient element within 5e-3 (relative and
absolute); and each leaf's worst element within 1e-4 of the leaf's rms
(the single-device gate of ``tests/test_torch_training.py``).  The
leaves' rms are 1.5e-3 to 3.4e-3 for the weight matrices, 9e-3 to
1.7e-2 for the norms and 3.0e-2 for the embedding, so the elementwise
gate alone would pass many a weight's element at twice its value; the
rms gate fails a gradient scaled by the number of stages and one
without stage 0's part of the embedding's, and the pipeline sits at
2.1e-5 of the rms or less."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import transformer as JT
from repro.training import train_step as JS
from repro_torch.models import transformer as T
from tests.test_torch_sharding import _spawn, _wait
from tests.test_torch_training import _rms, _within

LAYERS, MICRO = 4, 2


def _inputs():
    jcfg = dataclasses.replace(rregistry.get_smoke_config("qwen3-4b"),
                               n_layers=LAYERS, dtype=jnp.float32,
                               remat=False)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    lab = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    return jcfg, params, tok, lab


def test_gpipe_on_two_ranks_matches_the_single_program(tmp_path):
    """The pipeline's loss equals the reference's ``make_loss_fn`` and
    its gradients ``jax.grad``'s, every leaf, with two stages."""
    jcfg, params, tok, lab = _inputs()
    np.savez(tmp_path / "pp_in.npz", tokens=tok, labels=lab,
             **{f"w.{p}": np.asarray(a, np.float32)
                for p, a in T.tree_leaves(params)})
    case = dict(name="pp", arch="qwen3-4b", kind="pp", microbatches=MICRO,
                overrides={"n_layers": LAYERS, "remat": False})
    procs = _spawn(tmp_path, {"tag": "pp", "mesh": [2], "axes": ["pod"],
                              "cases": [case]}, 2)
    try:
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
        loss_fn = JS.make_loss_fn(jcfg)
        ref_loss, _ = loss_fn(params, batch)
        g_ref = jax.grad(lambda p: loss_fn(p, batch)[0])(params)
    finally:
        _wait(procs)
    got = dict(np.load(tmp_path / "pp_out.npz"))
    np.testing.assert_allclose(float(got["loss"]), float(ref_loss),
                               rtol=1e-4, atol=1e-4)
    want = {p: np.asarray(g) for p, g in T.tree_leaves(g_ref)}
    grads = {k[2:]: v for k, v in got.items() if k.startswith("g.")}
    assert grads.keys() == want.keys()
    for k in want:
        assert grads[k].shape == want[k].shape, k
        np.testing.assert_allclose(grads[k], want[k], rtol=5e-3, atol=5e-3,
                                   err_msg=k)
    # and each leaf's worst element within 1e-4 of the leaf's rms: a
    # gradient scaled by the number of stages, or missing a stage's part,
    # fails this where it could pass the elementwise gate above
    _within(grads, want, 1e-4, _rms)
    # every stage's blocks carry gradient: the schedule reached them all
    assert all(np.abs(grads[k]).max() > 0 for k in grads)
