"""The port's contract analysis (``repro_torch.analysis``,
``repro_torch.launch.analyze``) on the CPU, against the JAX package's
(``repro.analysis``): each rule passing on a port surface and firing on a
planted breach, each lint rule on a temporary tree, the collectives' wire
bytes against the reference's HLO accounting, the 25 surfaces' names and
launches, the verdicts and outputs the reference gives on the surfaces it
traces here (bit for bit, handed across as numpy), and the analyzer.

Tolerance: exact equality (int32 state; counts are integers)."""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.analysis import hlo as rhlo
from repro.analysis import surfaces as RS
from repro_torch.analysis import baselines, ir, lint, rules
from repro_torch.analysis import surfaces as S
from repro_torch.analysis.collectives import (GroupSizeError,
                                              collective_bytes)
from repro_torch.core import engine
from repro_torch.core import pushrelabel as pr
from repro_torch.kernels import runtime
from repro_torch.kernels.segmin import tile_min_neighbor_gather
from repro_torch.launch import analyze

ROOT = pathlib.Path(__file__).resolve().parents[1]
_I32 = torch.int32
PORT = {s.name: s for s in S.iter_surfaces(device="cpu")}
KERNEL_SURFACES = [n for n, s in PORT.items()
                   if s.tag_dict().get("kernel") == "True"
                   or s.tag_dict().get("mode", "vc") not in ("vc", "tc")]
#: the surfaces the reference traces on jax 0.9 here (its kernels need
#: ``pl.load``, its superstep ``set_mesh`` outside ``jit``)
REFERENCE_TRACED = ("run_cycles/vc/bcsr", "run_cycles/vc/rcsr",
                    "run_cycles/tc/bcsr", "run_cycles/tc/rcsr",
                    "batched_run_cycles/vc", "batched_run_cycles/tc",
                    "global_relabel/single", "global_relabel/batched",
                    "phase2/single", "phase2/batched",
                    "streaming/drain_prepared")


@pytest.fixture(scope="module")
def censuses():
    """Every port surface's census on the CPU, taken once."""
    return {n: S.analyze_surface(s) for n, s in PORT.items()}


def _loop_census(step_body, steps: int = 4):
    """The census of an engine loop of ``steps`` steps on the small
    fixture whose step is ``step_body(state) -> state``."""
    g, meta, state, s, t, _, _ = S.single_fixture("bcsr", "cpu")

    def step(c):
        return step_body(pr.PRState(*(x.clone() for x in c[0]))), c[1] + 1

    carry = (state, torch.zeros((), dtype=_I32))
    return ir.census(engine.run_bulk_loop, step, carry,
                     cond_fn=lambda c: c[1] < steps)


# ---------------------------------------------------------------------------
# the rules: passing on a surface, firing on a planted breach
# ---------------------------------------------------------------------------

def test_every_surface_holds_every_rule(censuses):
    bad = {n: [str(v) for v in vs] for n, (_, vs) in censuses.items() if vs}
    assert not bad


def test_no_per_row_launch_fires_on_a_launch_per_row(censuses):
    bg, meta, _, state = S.batched_fixture("cpu")
    c, _ = censuses["batched_run_cycles/vc_kernel"]
    assert rules.NoPerRowLaunch(3).check(c) == []

    def per_row(st):
        for b in range(bg.batch):  # the breach: B launches of one row
            tile_min_neighbor_gather(None, bg.indptr[b], bg.heads[b],
                                     st.res[b], st.h[b], n=meta.n)
        return st

    def step(c):
        return per_row(c[0]), c[1] + 1

    planted = ir.census(engine.run_bulk_loop, step,
                        (state, torch.zeros((), dtype=_I32)),
                        cond_fn=lambda c: c[1] < 4)
    got = rules.NoPerRowLaunch(3).check(planted, "planted")
    assert len(got) == 12 and "over 1 row(s)" in got[0].message
    assert rules.LaunchBudget(1).check(planted)


def test_launch_budget_fires_on_two_launches_a_step(censuses):
    assert rules.LaunchBudget(1).check(
        censuses["run_cycles/vc_kernel_bsearch/bcsr"][0]) == []
    g, meta, *_ = S.single_fixture("bcsr", "cpu")

    def twice(st):
        for _ in range(2):
            tile_min_neighbor_gather(None, g.indptr, g.heads, st.res, st.h,
                                     n=meta.n)
        return st

    got = rules.LaunchBudget(1).check(_loop_census(twice), "planted")
    assert len(got) == 1 and "launched 2 kernels" in got[0].message


def test_launch_budget_fires_on_a_launch_outside_a_step():
    g, meta, state, *_ = S.single_fixture("bcsr", "cpu")
    c = ir.census(tile_min_neighbor_gather, None, g.indptr, g.heads,
                  state.res, state.h, n=meta.n)
    assert c.kernel_call_count == 1 and c.steps == 0
    assert "outside any engine step" in str(rules.LaunchBudget(1).check(c)[0])


def test_no_host_sync_passes_the_engines_reads(censuses):
    c, _ = censuses["run_cycles/vc/bcsr"]
    assert c.host_reads == 5 and all(
        ir.is_engine_read(h.origin) for h in c.host_calls)
    assert rules.NoHostSync().check(c) == []


def test_no_host_sync_fires_on_an_item_inside_a_step():
    def item(st):
        if st.e.sum(dtype=_I32).item() < 0:  # the breach: a host read
            raise AssertionError("negative excess")
        return st

    c = _loop_census(item)
    got = rules.NoHostSync().check(c, "planted")
    assert len(got) == 4
    assert "_local_scalar_dense (read into Python) at test_torch_analysis" \
        in got[0].message
    assert rules.ChunkShape(1, 0).check(c, "planted")


def test_no_host_sync_fires_on_a_boolean_mask_index():
    c = _loop_census(lambda st: st._replace(h=st.h.index_put(
        (st.e > 0,), st.h[st.e > 0] + 0)))
    got = rules.NoHostSync().check(c, "planted")
    assert {v.message.split(" at ")[0] for v in got} == {
        "aten.index (boolean-mask index)",
        "aten.index_put (boolean-mask index)"}


def test_chunk_shape_holds_on_nested_loops(censuses):
    c, _ = censuses["phase2/batched/kernel"]
    assert (c.loop_shells, c.chunked_shells) == (3, 2)
    outer = [lp for lp in c.loops if lp.nested]
    assert outer and all(lp.chunk == 1 and set(lp.step_launches) == {0}
                         for lp in outer)
    assert rules.ChunkShape(3, 1).check(c) == []
    assert rules.ChunkShape(2, 1).check(c)[0].message == \
        "expected 2 engine loop(s), ran 3"


def test_chunk_shape_fires_on_a_hand_while_loop():
    g, meta, state, s, t, _, _ = S.single_fixture("bcsr", "cpu")

    def hand_loop(st):
        i = torch.zeros((), dtype=_I32)
        while bool(i < 4):  # the breach: a loop shell of its own
            st = pr.vc_step(g, meta, st, s, t)
            i = i + 1
        return st

    c = ir.census(hand_loop, state)
    got = rules.ChunkShape(1, 0).check(c, "planted")
    assert any("is not the engine's" in v.message for v in got)
    assert any("expected 1 engine loop(s), ran 0" == v.message for v in got)
    assert len(rules.NoHostSync().check(c)) == 5


def test_int32_lattice_passes_index_casts_narrowed_indices_and_bools(
        censuses):
    c, _ = censuses["run_cycles/vc/bcsr"]
    kinds = {(x.src, x.dst, x.index_only, x.index_source) for x in c.casts}
    # segment_min's int32 -> int64 index cast, nonzero_static's int64 ->
    # int32 queue
    assert ("int32", "int64", True, False) in kinds
    assert ("int64", "int32", False, True) in kinds
    assert rules.Int32Lattice().check(c) == []
    bools = _loop_census(lambda st: st._replace(
        e=st.e + (st.e > 0).to(_I32) * 0))
    assert any(x.src == "bool" for x in bools.casts)
    assert rules.Int32Lattice().check(bools) == []


def test_int32_lattice_fires_on_a_sum_without_dtype():
    def widen(st):
        total = st.e.sum()  # the breach: int32 -> int64
        return st._replace(e=torch.where(total > 0, st.e, st.e))

    got = rules.Int32Lattice().check(_loop_census(widen), "planted")
    assert len(got) == 4
    assert "int64 from int32 by aten.sum" in got[0].message
    assert "a non-cast op widened it" in got[0].message


def test_int32_lattice_fires_on_narrowing_state():
    def narrow(st):
        wide = st.res.long() + 1  # state cast to int64, used as a value
        return st._replace(res=(wide - 1).to(_I32))  # and narrowed back

    got = rules.Int32Lattice().check(_loop_census(narrow), "planted")
    msgs = [v.message for v in got]
    assert sum("narrowing int64 -> int32" in m for m in msgs) == 4
    assert sum("used as a value, not an index" in m for m in msgs) == 4


def test_int32_lattice_follows_an_index_cast_through_arithmetic():
    g, meta, state, *_ = S.single_fixture("bcsr", "cpu")

    def gathered(st):
        idx = g.heads.long() + 0  # an index cast, then index arithmetic
        return st._replace(res=st.res + st.h[idx.clamp(max=meta.n - 1)] * 0)

    c = _loop_census(gathered)
    assert all(x.index_only for x in c.casts if x.dst == "int64")
    assert rules.Int32Lattice().check(c) == []


def test_op_budget_passes_and_fires(censuses):
    c, _ = censuses["run_cycles/vc_kernel_bsearch/bcsr"]
    assert c.ops_per_step() == pytest.approx(73.5625)
    assert rules.OpBudget(150).check(c) == []
    got = rules.OpBudget(50).check(c, "tight")
    assert len(got) == 1 and "over the budget of 50" in got[0].message


# ---------------------------------------------------------------------------
# the census itself
# ---------------------------------------------------------------------------

def test_hooks_are_inert_without_a_census():
    assert runtime._census is None
    assert runtime.census_launch("x", 1, None) is runtime._NO_CENSUS
    assert runtime.census_loop(4, None, None, (), False) is \
        runtime._NO_CENSUS
    assert runtime.census_step() is None


def test_census_does_not_nest_and_resets_on_error():
    with pytest.raises(RuntimeError, match="already recording"):
        ir.census(ir.census, lambda: None)
    assert runtime._census is None
    with pytest.raises(ZeroDivisionError):
        ir.census(lambda: 1 / 0)
    assert runtime._census is None


def test_kernel_bodies_are_bracketed(censuses):
    c, _ = censuses["run_cycles/vc_kernel_bsearch/bcsr"]
    assert c.loop_counts() == (5, 16, 16)
    assert c.launches_by_kernel() == {"tile_min_neighbor_gather_rev": 16}
    assert c.kernel_op_count > 0
    launch = c.kernel_calls[0]
    assert (launch.rows, launch.q) == (1, 24)
    assert launch.origin.path == "core/pushrelabel.py"
    dense = censuses["global_relabel/batched/kernel"][0].kernel_calls[0]
    assert (dense.rows, dense.q) == (3, None)


def test_loop_counts_are_the_same_on_every_run(censuses):
    for name, (c, _) in censuses.items():
        if PORT[name].session is None:
            fn, args = PORT[name].build()
            assert ir.loop_counts(fn, *args) == c.loop_counts(), name


def test_distributed_surface_leaves_the_process_as_found():
    import torch.distributed as dist

    before = dist.is_initialized()
    c, violations = S.analyze_surface(PORT["distributed/superstep"])
    assert dist.is_initialized() == before and violations == []
    assert {(x.kind, x.group_size) for x in c.collectives} == {
        ("all-reduce", 1)}
    assert len(c.collectives) == c.steps == 12


# ---------------------------------------------------------------------------
# the lint
# ---------------------------------------------------------------------------

LINT_CASES = [
    ("loop-shell", "src/repro_torch/core/x.py",
     "def f(t):\n    while bool(t.any()):\n        pass\n",
     "src/repro_torch/core/engine.py"),
    ("device-literal", "src/repro_torch/api/x.py",
     "def f():\n    return torch.device('cuda')\n",
     "src/repro_torch/kernels/runtime.py"),
    ("host-sync", "src/repro_torch/core/x.py",
     "def f(x):\n    return x.item()\n", "src/repro_torch/serving/x.py"),
    ("int64-state-cast", "src/repro_torch/streaming/x.py",
     "def f(res):\n    return res.long()\n", "src/repro_torch/kernels/x.py"),
    ("bare-assert", "src/repro_torch/obs/x.py",
     "def f(x):\n    assert x\n", "src/repro/core/x.py"),
    ("private-walker", "tests/test_torch_x.py",
     "from torch.utils._python_dispatch import TorchDispatchMode\n"
     "class M(TorchDispatchMode):\n    pass\n", "tests/test_other.py"),
]


def _lint_tree(tmp_path, rel, source):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return lint.run_lint(tmp_path, ["src", "tests"])


@pytest.mark.parametrize("rule,rel,source,elsewhere", LINT_CASES,
                         ids=[c[0] for c in LINT_CASES])
def test_lint_rule_fires_in_scope(tmp_path, rule, rel, source, elsewhere):
    got = _lint_tree(tmp_path, rel, source)
    assert [(f.rule, f.path, f.line) for f in got] == [(rule, rel, 2)]


@pytest.mark.parametrize("rule,rel,source,elsewhere", LINT_CASES,
                         ids=[c[0] for c in LINT_CASES])
def test_lint_rule_passes_out_of_scope_and_under_a_pragma(
        tmp_path, rule, rel, source, elsewhere):
    assert _lint_tree(tmp_path, elsewhere, source) == []
    lines = source.splitlines()
    lines[1] += f"  # lint-ok: {rule} (a reason)"
    assert _lint_tree(tmp_path / "p", rel, "\n".join(lines) + "\n") == []


def test_lint_flags_a_literal_default_device(tmp_path):
    got = _lint_tree(tmp_path, "src/repro_torch/core/x.py",
                     "def f(x, device='cuda:0'):\n    return x\n")
    assert [(f.rule, f.line) for f in got] == [("device-literal", 1)]


def test_lint_blesses_a_cast_narrowed_through_as_state_dtype(tmp_path):
    src = ("def f(res):\n    x = res.astype(np.int64) + 1\n"
           "    return as_state_dtype(x)\n")
    assert _lint_tree(tmp_path, "src/repro_torch/core/x.py", src) == []


def test_repo_port_tree_is_lint_clean():
    assert lint.run_lint(ROOT) == []
    assert lint.main(["--root", str(ROOT), "--list-rules"]) == 0


# ---------------------------------------------------------------------------
# collectives against the reference's HLO accounting
# ---------------------------------------------------------------------------

HLO_LINES = {
    "all-reduce": "%r = s32[1024]{0} all-reduce(s32[1024]{0} %x), "
                  "replica_groups={{0,1,2,3}}, to_apply=%sum",
    "all-gather": "%r = s32[4096]{0} all-gather(s32[1024]{0} %x), "
                  "replica_groups={{0,1,2,3}}, dimensions={0}",
    "reduce-scatter": "%r = s32[256]{0} reduce-scatter(s32[1024]{0} %x), "
                      "replica_groups={{0,1,2,3}}, dimensions={0}",
    "all-to-all": "%r = s32[1024]{0} all-to-all(s32[1024]{0} %x), "
                  "replica_groups={{0,1,2,3}}, dimensions={0}",
    "collective-permute": "%r = s32[1024]{0} collective-permute(s32[1024]"
                          "{0} %x), source_target_pairs={{0,1},{1,0}}",
}
HLO_BYTES = {"all-reduce": 4096, "all-gather": 16384, "reduce-scatter": 1024,
             "all-to-all": 4096, "collective-permute": 4096}


@pytest.mark.parametrize("kind", sorted(HLO_LINES))
def test_collective_bytes_match_the_reference(kind):
    rec = ir.Collective(f"c10d.{kind}", kind, HLO_BYTES[kind], 4,
                        ir.Site("x.py", 1, "f"))
    want = rhlo.collective_bytes(HLO_LINES[kind])
    assert collective_bytes([rec, rec]) == rhlo.collective_bytes(
        HLO_LINES[kind] + "\n" + HLO_LINES[kind])
    assert collective_bytes([rec])["by_op"] == want["by_op"]


def test_collective_bytes_refuse_an_unknown_group_size():
    rec = ir.Collective("c10d.allreduce_", "all-reduce", 64, None,
                        ir.Site("x.py", 1, "f"))
    with pytest.raises(GroupSizeError):
        collective_bytes([rec])
    with pytest.warns(UserWarning, match="assuming 2"):
        assert collective_bytes([rec], strict=False)["total_bytes"] == 64


# ---------------------------------------------------------------------------
# parity with the reference's registry
# ---------------------------------------------------------------------------

def test_surface_names_and_families_equal_the_references():
    assert [(s.name, s.family) for s in RS.iter_surfaces()] == [
        (s.name, s.family) for s in PORT.values()]


def test_launches_per_step_equal_the_references_but_bsearch():
    assert S.REFERENCE_LAUNCHES_PER_STEP == RS._LAUNCHES_PER_STEP
    diff = {m for m in S.LAUNCHES_PER_STEP
            if S.LAUNCHES_PER_STEP[m] != RS._LAUNCHES_PER_STEP[m]}
    assert diff == {"vc_kernel_bsearch"}
    assert S.LAUNCHES_PER_STEP["vc_kernel_bsearch"] == 1


def _np_leaves(x):
    leaves = jax.tree_util.tree_leaves(x) if not isinstance(
        x, torch.Tensor) else [x]
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf.numpy())
        elif isinstance(leaf, tuple):  # a torch NamedTuple inside
            out += _np_leaves(list(leaf))
        else:
            out.append(np.asarray(leaf))
    return out


def _torch_leaves(x):
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [a for item in x for a in _torch_leaves(item)]


def _reference_run(name):
    """The reference's output of surface ``name`` on the shared fixture
    (the drain: the reference's drain on the port's fixture arrays)."""
    import jax.numpy as jnp

    from repro.core import pushrelabel as rpr
    from repro.streaming import reroute as rreroute

    if name == "streaming/drain_prepared":
        rows, meta, *arrays = S.drain_fixture("cpu")
        g = rpr.DeviceGraph(*(jnp.asarray(x.numpy()) for x in rows))
        rmeta = rpr.GraphMeta(meta.n, meta.num_arcs, meta.deg_max,
                              meta.layout)
        return rreroute._batched_reroute_impl(
            g, rmeta, *(jnp.asarray(x.numpy()) for x in arrays))
    surf = next(s for s in RS.iter_surfaces() if s.name == name)
    fn, args = surf.build()
    port_args = PORT[name].build()[1]
    for a, b in zip(args, port_args):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return fn(*args)


@pytest.mark.parametrize("name", REFERENCE_TRACED)
def test_outputs_equal_the_references_bit_for_bit(name):
    fn, args = PORT[name].build()
    got = _torch_leaves(fn(*args))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        _reference_run(name))]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_verdicts_equal_the_references(censuses):
    for name in REFERENCE_TRACED:
        surf = next(s for s in RS.iter_surfaces() if s.name == name)
        _, ref = RS.analyze_surface(surf)
        ref_bad = {v.rule for v in ref} & {"int32-lattice", "no-host-sync"}
        port_bad = {v.rule for v in censuses[name][1]} & {"int32-lattice",
                                                          "no-host-sync"}
        assert ref_bad == port_bad == set(), name


@pytest.mark.parametrize("name", [
    n for n in KERNEL_SURFACES
    # its loop exits on a launch of K = 8 cycles that pushed nothing, not
    # on such a cycle, so it climbs further than vc before it stops
    if n != "batched_run_cycles/vc_fused"])
def test_kernel_surfaces_equal_their_plain_surfaces(name):
    plain = name.replace("/kernel", "")
    for mode in ("vc_kernel_bsearch", "vc_kernel", "vc_fused"):
        plain = plain.replace(f"/{mode}", "/vc")
    fn, args = PORT[name].build()
    pfn, pargs = PORT[plain].build()
    for a, b in zip(_torch_leaves(fn(*args)), _torch_leaves(pfn(*pargs))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# baselines and the analyzer
# ---------------------------------------------------------------------------

def test_baselines_count_the_gate_a_step():
    base = baselines.chunk_baselines(device="cpu")
    assert set(base) == {"vc", "tc", "vc_kernel", "vc_kernel_bsearch"}
    for mode, b in base.items():
        assert b["gate_ops_per_step"] > 0
        assert b["launches_per_step"] == S.LAUNCHES_PER_STEP[mode]


def test_analyzer_payload_and_cli(tmp_path):
    out = tmp_path / "ANALYSIS_torch.json"
    assert analyze.main(["--device", "cpu", "--smoke", "--root", str(ROOT),
                         "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert set(payload) >= {"surfaces", "lint", "baselines", "summary"}
    s = payload["summary"]
    assert (s["surfaces_traced"], s["surfaces_clean"], s["rule_violations"],
            s["lint_findings"]) == (25, 25, 0, 0)
    rec = payload["surfaces"]["run_cycles/vc/bcsr"]
    assert rec["device"] == "cpu" and rec["capturable"] is None
    assert rec["census"]["loop_shape"] == {
        "loops": 1, "chunked": 1, "steps": 16, "host_reads": 5,
        "kernel_calls": 0}
    assert baselines.load_baselines(out) == payload["baselines"]


def test_analyzer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze.run_analysis(with_lint=False, with_baselines=False)
