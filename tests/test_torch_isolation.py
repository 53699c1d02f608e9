"""The port stands alone: no module of ``repro_torch``, nothing that
``chip_smoke.py`` imports and nothing the card-only tests import pulls in
``jax`` or the JAX package ``repro``.

Checked twice: by importing everything in a fresh interpreter and reading
``sys.modules``, and by scanning the sources' import statements."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
#: the port's examples, scripts that run on import
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
#: the card-only tests run where JAX is not installed
SOURCES = sorted(PORT.rglob("*.py")) + [SMOKE, ROOT / "chip_steptime.py",
                                        ROOT / "tests" / "test_torch_cuda.py",
                                        *EXAMPLES]


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _imported_names(path: pathlib.Path) -> list[str]:
    """Every module an ``import``/``from ... import`` in ``path`` names,
    at any depth (function-local imports included)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_sources_import_no_jax_and_no_repro(path):
    bad = [n for n in _imported_names(path) if _is_forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_everything_loads_no_jax_and_no_repro():
    modules = [_module_name(p) for p in sorted(PORT.rglob("*.py"))]
    # chip_smoke's own imports (function-local ones too), then the script
    # itself as a module: importing it does not run it
    modules += sorted({n for path in (SMOKE, *EXAMPLES)
                       for n in _imported_names(path)
                       if n.split(".")[0] != "__future__"})
    code = (
        "import importlib, json, runpy, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({str(SMOKE)!r}, run_name='chip_smoke')\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "repro_torch.core.pushrelabel" in modules  # the walk saw it
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.mesh",
            "repro_torch.configs.registry"} <= set(modules)
    # three max-flow examples, the LM serving and the LM training ones
    assert len(EXAMPLES) == 5
