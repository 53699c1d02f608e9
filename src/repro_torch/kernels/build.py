"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (one or more entry
points, :data:`SIGNATURES`) and is compiled by ``nvcc`` for ``sm_90a``
into its own shared library, loaded with ``ctypes``.  A library is built
at first use into ``build/repro_torch/`` at the root of the checkout (for
an installed package, which has no checkout, into ``repro_torch/`` under
``$XDG_CACHE_HOME`` or ``~/.cache``) and named by a hash of its source, of
every ``csrc/*.cuh`` header the source includes (directly or through
another header), and of the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source, all at once.  A failed
build raises; nothing falls back to the plain PyTorch versions.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"


def build_dir(module: pathlib.Path) -> pathlib.Path:
    """Where the libraries of the package holding ``module`` (this file)
    are built: ``build/repro_torch/`` of the checkout when the package
    runs from its ``src/`` tree, else a per-user cache directory."""
    root = module.resolve().parents[3]
    if module.resolve().parents[2].name == "src" and (
            root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or pathlib.Path.home() / ".cache"
    return pathlib.Path(cache) / "repro_torch"


BUILD_DIR = build_dir(pathlib.Path(__file__))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: argtypes of each library's entry points, by symbol (pointers and the
#: stream as ``c_void_p``, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "segmin": {
        # avq|NULL, indptr, key, minh, argarc, batch, q, n, a, stream
        "tile_min_neighbor_launch": (_P,) * 5 + (_I,) * 4 + (_P,),
        # avq|NULL, indptr, heads, res, h, minh, argarc, batch, q, n, a,
        # stream
        "tile_min_neighbor_gather_launch": (_P,) * 7 + (_I,) * 4 + (_P,),
        # avq, indptr, heads, tails, res, h, minh, argarc, rev, batch, q, n,
        # a, steps, stream
        "tile_min_neighbor_gather_rev_launch": (_P,) * 9 + (_I,) * 5 + (_P,),
    },
    # arcs, indptr, heads, tails, out, batch, p, n, a, steps, stream
    "revsearch": {"bcsr_rev_search_launch": (_P,) * 5 + (_I,) * 5 + (_P,)},
    # s, t, indptr, heads, rev, res, h, e (in place), gate|NULL, queue,
    # decisions, live, pushed, cnt, batch, n, a, k, stream
    "discharge": {"fused_discharge_launch": (_P,) * 14 + (_I,) * 4 + (_P,)},
}

_lock = threading.Lock()
_entry: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "cannot be built")
    return str(path)


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"/]+\.cuh)"', re.M)


def sources(name: str) -> dict[str, bytes]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly
    or through another header, by file name."""
    out: dict[str, bytes] = {}
    todo = [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f not in out:
            out[f] = (CSRC / f).read_bytes()
            todo += [m.decode() for m in _INCLUDE.findall(out[f])]
    return out


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f, text in sorted(sources(name).items()):
        digest.update(f"\0{f}\0{len(text)}\0".encode() + text)
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Build every missing library (one ``nvcc`` per source, started
    together) and return the compiler's output per source, which holds
    ``-Xptxas -v``'s register and spill report."""
    names = sorted(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def entry(name: str, symbol: str) -> ctypes._CFuncPtr:
    """The launch function ``symbol`` of ``csrc/<name>.cu``, built on
    first use."""
    fn = _entry.get((name, symbol))
    if fn is None:
        with _lock:
            fn = _entry.get((name, symbol))
            if fn is None:
                build_all([name])
                fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
                fn.argtypes = list(SIGNATURES[name][symbol])
                fn.restype = ctypes.c_int
                _entry[(name, symbol)] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
