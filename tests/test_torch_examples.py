"""The port's examples (``examples/*_torch.py``), each run as a script in
a subprocess on the CPU (``--device cpu``): each max-flow example
verifies itself against the Dinic oracle, the LM serving example
(``serve_decode_torch.py``) its caches against teacher forcing, and each
exits 0.  Without that flag and without a card each fails, rather than
falling back to the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart_torch.py", "bipartite_matching_torch.py",
            "serve_maxflow_torch.py")
ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "PYTHONPATH": str(ROOT / "src")}


def _run(name, *args):
    return subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *args], env=ENV, cwd=ROOT, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_and_verifies_on_the_cpu(name):
    r = _run(name, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "verified against Dinic" in r.stdout
    assert "cpu" in r.stdout  # it says where it ran


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_card_fails(name):
    """No card here: the default device raises, no CPU fallback."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable")
    r = _run(name)
    assert r.returncode != 0
    assert "no CUDA device is visible" in r.stderr
    assert "verified" not in r.stdout


LM_EXAMPLE = "serve_decode_torch.py"


def test_serve_decode_example_runs_on_the_cpu():
    """rwkv6, mixtral and jamba at SMOKE served through the launcher, each
    cache held in float32 against teacher forcing."""
    r = _run(LM_EXAMPLE, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    for arch in ("rwkv6-1.6b", "mixtral-8x7b", "jamba-1.5-large-398b"):
        assert f"arch={arch}-smoke batch=4" in r.stdout
        assert f"{arch}: served on cpu" in r.stdout
    assert r.stdout.strip().splitlines()[-1].startswith(
        "verified: 3 archs' prefill + decode caches on cpu")


def test_serve_decode_example_without_a_card_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable")
    r = _run(LM_EXAMPLE)
    assert r.returncode != 0
    assert "no CUDA device is visible" in r.stderr
    assert "verified" not in r.stdout
