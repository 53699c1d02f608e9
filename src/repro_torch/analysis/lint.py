"""AST lint of the port's source tree: invariants the census cannot see
(the port of ``repro.analysis.lint``, re-targeted at ``src/repro_torch``).

The contract rules (:mod:`repro_torch.analysis.rules`) hold for code
that ran; this module holds for the source, so that nobody even wrote
the code that would break them.  It lints port paths only, never the
JAX package.

Rule catalogue (scopes are repo-relative prefixes or globs,
:data:`RULE_SCOPES`):

``loop-shell``
    no ``while`` loop whose test reads a tensor (``bool(...)``,
    ``int(...)``, ``.item()``, ``torch.any``/``torch.all``) in solver
    code outside ``core/engine.py``: every bulk-synchronous loop runs on
    the sweep engine, one host read a chunk.
``device-literal``
    no literal ``"cpu"``/``"cuda"`` device in solver code (a parameter's
    default, ``torch.device("cuda")``, ``device="cpu"``) outside
    ``kernels/runtime.py``, whose ``resolve_device`` is the one place a
    device is chosen (the reference's ``interpret-literal``).
``host-sync``
    no ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` or
    ``torch.cuda.synchronize`` under ``core/`` or ``kernels/``: host
    synchronisation is the drivers' decision, made between chunks, and
    each site says so with a pragma.
``int64-state-cast``
    a cast of a state-named array (``res``/``res0``/``e``/``h``/``b``/
    ``excess``/``state``...) to int64 (``.long()``, ``.to(torch.int64)``,
    ``astype(np.int64)``, ``np.asarray(x, np.int64)``) must sit in a
    function that also narrows through ``as_state_dtype``, or carry a
    pragma saying it stays on the host.
``bare-assert``
    no message-less ``assert`` in library code (``-O`` strips it).
``private-walker``
    no ``TorchDispatchMode`` subclass or ``__torch_dispatch__`` in the
    port's tests or ``chip_smoke.py``: every census goes through
    :mod:`repro_torch.analysis.ir`.

Suppression: append ``# lint-ok: <rule>[, <rule>...]`` to the line, and
say why after it.

    python -m repro_torch.analysis.lint                 # the port's tree
    python -m repro_torch.analysis.lint src/repro_torch
    python -m repro_torch.analysis.lint --list-rules
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import fnmatch
import re
import sys
from pathlib import Path
from typing import Iterable, Iterator

__all__ = ["LintFinding", "run_lint", "lint_file", "RULE_SCOPES",
           "DEFAULT_PATHS", "main"]

_PRAGMA_RE = re.compile(r"#\s*lint-ok:\s*([\w-]+(?:\s*,\s*[\w-]+)*)")

#: array names that hold solver state (the int32 device lattice)
_STATE_NAMES = frozenset({
    "res", "res0", "res2", "e", "h", "b", "excess", "state",
    "prev_res", "prev_e", "prev_h",
})

_PORT = "src/repro_torch"
_SOLVER = tuple(f"{_PORT}/{d}" for d in ("core", "kernels", "streaming",
                                          "serving"))

#: rule name -> (included path prefixes or globs, excluded exact paths)
RULE_SCOPES = {
    "loop-shell": (_SOLVER, (f"{_PORT}/core/engine.py",)),
    "device-literal": ((_PORT,), (f"{_PORT}/kernels/runtime.py",)),
    "host-sync": ((f"{_PORT}/core", f"{_PORT}/kernels"), ()),
    "int64-state-cast": ((f"{_PORT}/core", f"{_PORT}/streaming",
                          f"{_PORT}/serving", f"{_PORT}/api"), ()),
    "bare-assert": (_SOLVER + tuple(f"{_PORT}/{d}" for d in (
        "api", "obs", "graphs", "analysis", "launch", "runtime", "configs",
        "models", "training")), ()),
    "private-walker": (("tests/test_torch_*.py", "chip_smoke.py"), ()),
}

#: what ``run_lint`` walks by default: the port, its tests, the smoke run
DEFAULT_PATHS = (_PORT, "tests", "chip_smoke.py")

_DEVICES = re.compile(r"^(cpu|cuda)(:\d+)?$")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One source-level invariant violation."""

    rule: str
    path: str  # repo-relative
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _pragmas(source: str) -> dict[int, frozenset[str]]:
    out = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            out[i] = frozenset(p.strip() for p in m.group(1).split(","))
    return out


def _in_scope(rule: str, rel: str) -> bool:
    include, exclude = RULE_SCOPES[rule]
    if rel in exclude:
        return False
    return any(rel == p or rel.startswith(p + "/") or fnmatch.fnmatch(rel, p)
               for p in include)


def _attr_chain(node) -> tuple[str, ...]:
    """``torch.cuda.synchronize`` -> ('torch', 'cuda', 'synchronize');
    empty for anything that is not a plain name/attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _root_state_name(node) -> str | None:
    """The state name a cast source resolves to: bare ``res``, attribute
    ``state.res`` / ``self._res``, or a subscript or method call of
    either."""
    while isinstance(node, (ast.Subscript, ast.Call)):
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node.func, ast.Attribute):
            node = node.func.value
        else:
            return None
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    else:
        return None
    return name if name.lstrip("_") in _STATE_NAMES else None


def _is_int64(node) -> bool:
    chain = _attr_chain(node)
    if chain and chain[-1] in ("int64", "uint64", "long"):
        return True
    return isinstance(node, ast.Constant) and node.value in ("int64",
                                                             "uint64")


def _int64_cast_source(call: ast.Call):
    """The array being cast when ``call`` is an int64 cast: ``X.long()``,
    ``X.to(torch.int64)``, ``X.astype(np.int64)``, ``np.(as)array(X,
    int64)``; else None."""
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr == "long" and not call.args:
            return func.value
        if func.attr in ("astype", "to", "type"):
            dtypes = list(call.args) + [kw.value for kw in call.keywords
                                        if kw.arg == "dtype"]
            if any(_is_int64(a) for a in dtypes):
                return func.value
    chain = _attr_chain(func)
    if chain and chain[-1] in ("asarray", "array", "ascontiguousarray"):
        dtypes = list(call.args[1:]) + [kw.value for kw in call.keywords
                                        if kw.arg == "dtype"]
        if call.args and any(_is_int64(a) for a in dtypes):
            return call.args[0]
    return None


def _reads_tensor(test) -> bool:
    """Whether a loop test reads a tensor into Python."""
    for node in ast.walk(test):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if chain in (("bool",), ("int",), ("float",)):
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr == "item":
            return True
        if len(chain) >= 2 and chain[0] == "torch" and chain[-1] in ("any",
                                                                     "all"):
            return True
    return False


def _is_device_literal(node) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and bool(_DEVICES.match(node.value)))


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, pragmas: dict[int, frozenset[str]]):
        self.rel = rel
        self.pragmas = pragmas
        self.findings: list[LintFinding] = []
        # functions (by line span) that call as_state_dtype: the blessed
        # narrowing of the widen-compute-narrow pattern
        self._blessed: list[tuple[int, int]] = []
        self._pending: list[tuple[int, str]] = []
        self._fns: list[tuple[int, int]] = []

    def _flag(self, rule: str, node, message: str):
        line = node if isinstance(node, int) else getattr(node, "lineno", 0)
        if rule in self.pragmas.get(line, ()) or not _in_scope(rule,
                                                               self.rel):
            return
        self.findings.append(LintFinding(rule=rule, path=self.rel,
                                         line=line, message=message))

    def visit_While(self, node: ast.While):
        if _reads_tensor(node.test):
            self._flag("loop-shell", node,
                       "while loop on a tensor read outside core/engine.py "
                       "— run it on engine.run_bulk_loop / run_to_fixpoint, "
                       "one host read a chunk")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        chain = _attr_chain(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
        if attr in ("item", "cpu", "tolist", "numpy") or \
                chain[-3:] == ("torch", "cuda", "synchronize"):
            self._flag("host-sync", node,
                       f".{attr}() in solver code synchronises with the "
                       "host: keep it between chunks and say so with "
                       "'# lint-ok: host-sync'")
        if chain:
            if chain[-1] == "as_state_dtype" and self._fns:
                self._blessed.append(self._fns[-1])
            if chain[-2:] == ("torch", "device") and node.args and \
                    _is_device_literal(node.args[0]):
                self._flag("device-literal", node,
                           f"torch.device({node.args[0].value!r}) — let "
                           "kernels.runtime.resolve_device choose")
        for kw in node.keywords:
            if kw.arg == "device" and _is_device_literal(kw.value):
                self._flag("device-literal", kw.value,
                           f"device={kw.value.value!r} — let kernels.runtime."
                           "resolve_device choose")
        src = _int64_cast_source(node)
        if src is not None:
            state = _root_state_name(src)
            if state is not None:
                self._pending.append(
                    (node.lineno,
                     f"int64 cast of state array {state!r} without an "
                     "as_state_dtype narrowing in the same function; "
                     "widen-compute-narrow through as_state_dtype, or "
                     "declare the host-side exception with "
                     "'# lint-ok: int64-state-cast'"))
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert):
        if node.msg is None:
            self._flag("bare-assert", node,
                       "message-less assert in library code (stripped "
                       "under -O); raise a typed error or attach a message")
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef):
        if any(_attr_chain(b)[-1:] == ("TorchDispatchMode",)
               for b in node.bases):
            self._flag("private-walker", node,
                       f"TorchDispatchMode subclass {node.name!r}: take the "
                       "census from repro_torch.analysis.ir")
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        self._visit_fn(node)

    def visit_AsyncFunctionDef(self, node):
        self._visit_fn(node)

    def _visit_fn(self, node):
        if node.name == "__torch_dispatch__":
            self._flag("private-walker", node,
                       "__torch_dispatch__ outside repro_torch.analysis.ir: "
                       "take the census from there")
        for d in node.args.defaults + node.args.kw_defaults:
            if d is not None and _is_device_literal(d):
                self._flag("device-literal", d,
                           f"default device {d.value!r} — default to None "
                           "and let kernels.runtime.resolve_device choose")
        span = (node.lineno, max((n.lineno for n in ast.walk(node)
                                  if hasattr(n, "lineno")),
                                 default=node.lineno))
        self._fns.append(span)
        self.generic_visit(node)
        self._fns.pop()

    def finish(self):
        for line, message in self._pending:
            if not any(lo <= line <= hi for lo, hi in self._blessed):
                self._flag("int64-state-cast", line, message)


def lint_file(path: Path, root: Path) -> list[LintFinding]:
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    if not any(_in_scope(rule, rel) for rule in RULE_SCOPES):
        return []
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as ex:
        return [LintFinding(rule="parse-error", path=rel,
                            line=ex.lineno or 0, message=str(ex))]
    v = _Visitor(rel, _pragmas(source))
    v.visit(tree)
    v.finish()
    return sorted(v.findings, key=lambda f: (f.path, f.line, f.rule))


def _iter_py(root: Path, paths: Iterable[str]) -> Iterator[Path]:
    for sub in paths:
        base = root / sub
        if base.is_file() and base.suffix == ".py":
            yield base
        elif base.is_dir():
            yield from sorted(base.rglob("*.py"))


def run_lint(root: Path | str, paths: Iterable[str] = DEFAULT_PATHS
             ) -> list[LintFinding]:
    """Lint ``paths`` (files or directories under ``root``); all
    findings, stably ordered."""
    root = Path(root)
    out: list[LintFinding] = []
    for path in _iter_py(root, paths):
        out.extend(lint_file(path, root))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST lint for the port's source-side invariants")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files or subtrees to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--root", default=".", help="the repository's root")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and scopes, then exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, (include, exclude) in RULE_SCOPES.items():
            print(f"{rule}: {', '.join(include)}"
                  + (f" (except {', '.join(exclude)})" if exclude else ""))
        return 0
    findings = run_lint(args.root, args.paths)
    for f in findings:
        print(f)
    print(f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
