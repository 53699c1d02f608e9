"""The max-flow half of the port's dry run (``repro_torch.configs``,
``launch/shapes.py``, ``launch/mesh.py``, ``launch/dryrun.py``) against
the JAX package's, on the CPU.

The reference runs in two subprocesses started together: one with 512
forced XLA host devices (``repro.launch.dryrun`` sets that flag itself),
which gives ``_graph_specs``' meta and per-device shard shapes for all 12
production cells, and one with 8, which lowers and compiles
``_lower_graph``'s step and sweep on a ``(2, 4)`` mesh for a cell of
2^14 arcs and 2^11 vertices and counts their collectives in the HLO.
The port runs one rank of the same cell under ``mesh.fake_world(8, 1)``
and counts its collectives with the op census.  Tolerance: exact
equality, except the ``sparse`` step, where the reference's HLO count has
no all-to-all and the port's step issues one (a difference of the
accounting, not of the algorithm)."""
import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as rregistry
from repro.configs import wbpr_maxflow as rwbpr
from repro.launch import shapes as rshapes
from repro_torch.configs import registry
from repro_torch.configs import wbpr_maxflow
from repro_torch.launch import dryrun, mesh as tmesh, shapes

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
       "PYTHONPATH": str(ROOT / "src")}
TIMEOUT = 240
#: the collectives cell: the reference's lowering checked on jax 0.9
CELL = shapes.ShapeCell("g", "maxflow", 2**14, 2**11)
HOST_MESH = tmesh.Mesh((2, 4), ("data", "model"))

REF_SPECS = r"""
import dataclasses, json, sys
from repro.launch import dryrun as RD  # forces 512 host devices
from repro.launch import shapes as SH
from repro.launch.mesh import make_production_mesh
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    axes = tuple(mesh.axis_names)
    for cell in SH.GRAPH_SHAPES.values():
        for mode in ("replicated", "sharded", "sparse"):
            meta, g, res, h, e = RD._graph_specs(cell, mesh, axes, mode)
            arrays = dict(g._asdict(), res=res, h=h, e=e)
            out[f"{cell.name}|{RD._mesh_tag(mp)}|{mode}"] = {
                "meta": dataclasses.asdict(meta),
                "devices": mesh.devices.size,
                "shard": {k: list(x.sharding.shard_shape(x.shape))
                          for k, x in arrays.items()}}
print("JSON" + json.dumps(out))
"""

REF_LOWER = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()  # 8 devices before the dry-run module sets its own flag
from repro import compat
from repro.launch import dryrun as RD
from repro.launch import hlo_analysis as H
from repro.launch import shapes as SH
mesh = compat.make_mesh((2, 4), ("data", "model"))
cell = SH.ShapeCell("g", "maxflow", 2**14, 2**11)
out = {}
for mode in ("replicated", "sharded", "sparse"):
    full, step_l, sweep_l, meta = RD._lower_graph(cell, mesh, mode)
    out[mode] = {"step": H.cost_summary(step_l.compile())["collectives"],
                 "gr_sweep": H.cost_summary(sweep_l.compile())["collectives"]}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """Both reference subprocesses, started together."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", script], env=ENV, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, script in (("specs", REF_SPECS), ("lower", REF_LOWER))}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, stderr[-3000:]
        line = next(ln for ln in stdout.splitlines() if ln.startswith("JSON"))
        out[name] = json.loads(line[4:])
    return out


# ---------------------------------------------------------------------------
# configs, registry, shapes, mesh
# ---------------------------------------------------------------------------

def test_registry_matches_the_reference():
    assert registry.ARCH_IDS == rregistry.ARCH_IDS
    for g in (False, True):
        assert registry.all_arch_ids(g) == rregistry.all_arch_ids(g)
    assert dataclasses.asdict(registry.get_config("wbpr-maxflow")) == \
        dataclasses.asdict(rregistry.get_config("wbpr-maxflow"))
    assert dataclasses.asdict(registry.get_smoke_config("wbpr-maxflow")) \
        == dataclasses.asdict(rregistry.get_smoke_config("wbpr-maxflow"))


def test_wbpr_config_matches_the_reference():
    for mine, ref in ((wbpr_maxflow.CONFIG, rwbpr.CONFIG),
                      (wbpr_maxflow.SMOKE, rwbpr.SMOKE)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(wbpr_maxflow.GraphConfig)] \
        == [f.name for f in dataclasses.fields(rwbpr.GraphConfig)]


LM_ARCHS = [a for a in rregistry.ARCH_IDS if a != "wbpr-maxflow"]


def _fields(cfg) -> dict:
    """A config's fields, its dtype by name (``torch.bfloat16`` and
    ``jnp.bfloat16`` both ``"bfloat16"``)."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    dt = out["dtype"]
    out["dtype"] = (str(dt).removeprefix("torch.")
                    if isinstance(dt, torch.dtype) else np.dtype(dt).name)
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_the_reference(arch):
    for get, rget in ((registry.get_config, rregistry.get_config),
                      (registry.get_smoke_config,
                       rregistry.get_smoke_config)):
        assert _fields(get(arch)) == _fields(rget(arch))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_dryrun_cells_are_not_ported_yet(arch, monkeypatch):
    """Once refused, an LM arch's cells now run (the LM cells of the dry
    run are ported): ``run_cell`` builds every production cell's record
    (its lowering stubbed here: the LM cells' own tests below run it),
    and ``long_500k`` on a full-attention arch gives the reference's skip
    record."""
    seen = []
    monkeypatch.setattr(dryrun, "_lower_lm", lambda cfg, cell, *a: (
        seen.append((cfg.name, cell.name)) or {
            "variant_costs": {}, "extrapolated": {
                "peak_allocated_bytes": None}}))
    cfg = registry.get_config(arch)
    for shape in shapes.LM_SHAPES:
        for mp in (False, True):
            rec = dryrun.run_cell(arch, shape, mp, device="cpu")
            assert (rec["arch"], rec["shape"], rec["mesh"]) == (
                arch, shape, "2x16x16" if mp else "16x16")
            cells = [c.name for c in shapes.cells_for(cfg)]
            if shape in cells:
                assert not rec["skipped"] and rec["kind"] == \
                    shapes.LM_SHAPES[shape].kind
                assert rec["full"]["memory"]["arg_bytes"]["total"] > 0
            else:
                assert rec == {"arch": arch, "shape": shape,
                               "mesh": rec["mesh"], "skipped": True,
                               "reason": "full-attention arch: "
                               "long-context decode is quadratic; skipped "
                               "per DESIGN.md §5"}
    assert len(seen) == 2 * len(shapes.cells_for(cfg))


def test_shapes_match_the_reference():
    for mine, ref in ((shapes.LM_SHAPES, rshapes.LM_SHAPES),
                      (shapes.GRAPH_SHAPES, rshapes.GRAPH_SHAPES)):
        assert {k: dataclasses.asdict(v) for k, v in mine.items()} == \
            {k: dataclasses.asdict(v) for k, v in ref.items()}
    assert shapes.GRAPH_SHAPES["graph_16m"].seq == 2**24
    assert shapes.GRAPH_SHAPES["graph_128m"].batch == 2**24


@pytest.mark.parametrize("arch", rregistry.ARCH_IDS)
def test_cells_for_matches_the_reference(arch):
    """The port's rules on the reference's own configs (LM ones too)."""
    cfg = rregistry.get_config(arch)
    assert [dataclasses.asdict(c) for c in shapes.cells_for(cfg)] == \
        [dataclasses.asdict(c) for c in rshapes.cells_for(cfg)]
    assert shapes.subquadratic(cfg) == rshapes.subquadratic(cfg)


def test_production_meshes():
    m = tmesh.production_mesh(False)
    assert (m.shape, m.axis_names, m.size, m.tag) == (
        (16, 16), ("data", "model"), 256, "16x16")
    m = tmesh.production_mesh(True)
    assert (m.shape, m.axis_names, m.size, m.tag) == (
        (2, 16, 16), ("pod", "data", "model"), 512, "2x16x16")
    with pytest.raises(ValueError):
        tmesh.Mesh((2, 4), ("data",))


def test_fake_world_opens_and_closes_the_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        tmesh.host_world()
    with tmesh.fake_world(8, 3):
        assert (dist.get_world_size(), dist.get_rank()) == (8, 3)
        assert tmesh.host_world() == tmesh.Mesh((2, 4), ("data", "model"))
        with pytest.raises(RuntimeError, match="already open"):
            with tmesh.fake_world(8, 1):
                pass
        x = torch.arange(6, dtype=torch.int32)
        dist.all_reduce(x)  # returns at once, untouched
        assert x.tolist() == list(range(6))
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with tmesh.fake_world(4, 4):
            pass


# ---------------------------------------------------------------------------
# meta and shard shapes of the 12 production cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", dryrun.GRAPH_MODES)
@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("shape", sorted(shapes.GRAPH_SHAPES))
def test_graph_specs_match_the_reference(reference, shape, multi_pod, mode):
    mesh = tmesh.production_mesh(multi_pod)
    meta, sh = dryrun._graph_specs(shapes.GRAPH_SHAPES[shape], mesh, mode)
    ref = reference["specs"][f"{shape}|{mesh.tag}|{mode}"]
    assert dataclasses.asdict(meta) == ref["meta"]
    assert mesh.size == ref["devices"]
    # the reference's slabs are (P, .) arrays, one row a device
    want = {k: (v[1:] if k in ("indptr", "heads", "rev", "tail_local")
                or (k == "res" and mode != "replicated") else v)
            for k, v in ref["shard"].items()}
    assert {k: list(v) for k, v in sh.items()} == want
    # every cell holds the synthetic graph, degree 8
    assert len(dryrun.offsets(meta)) == meta.amax // meta.vs == 8


def test_jobs_cover_twelve_cells():
    """``--all --arch wbpr-maxflow`` covers the twelve graph cells; without
    the arch, every LM arch's four shapes on both meshes too."""
    args = argparse.Namespace(
        both_meshes=True, multi_pod=False, graph_mode=None)
    every = dryrun._jobs(args)
    assert len(every) == 12 + len(LM_ARCHS) * 4 * 2 == len(set(every))
    args.arch = "wbpr-maxflow"
    jobs = dryrun._jobs(args)
    assert len(jobs) == 12 == len(set(jobs))
    assert {dryrun.record_name(a, s, dryrun._mesh_tag(mp), m)
            for a, s, mp, m in jobs} == {
        f"wbpr-maxflow__{s}__{t}{'' if m == 'replicated' else '__' + m}"
        ".json" for s in shapes.GRAPH_SHAPES for t in ("16x16", "2x16x16")
        for m in dryrun.GRAPH_MODES}


def test_all_runs_cells_in_one_process(tmp_path, monkeypatch):
    """``--all`` runs its cells one after another in this process, each
    under a fake group of its own, and records a failing cell without
    stopping (cells shrunk to the collectives cell on the host mesh)."""
    jobs = [("wbpr-maxflow", "graph_16m", False, m)
            for m in ("replicated", "sparse")]
    jobs.append(("wbpr-maxflow", "graph_16m", True, "no-such-mode"))
    run_cell = dryrun.run_cell
    monkeypatch.setattr(dryrun, "_jobs", lambda args: jobs)
    monkeypatch.setattr(dryrun, "run_cell", lambda arch, shape, mp, mode,
                        **kw: run_cell(arch, CELL, mp, mode, mesh=HOST_MESH,
                                       **{**kw, "reps": 1}))
    args = argparse.Namespace(fresh=True, device="cpu", seed=0)
    assert dryrun.run_all(args, tmp_path) == 1
    assert not dist.is_initialized()
    for mode in ("replicated", "sparse"):
        rec = json.loads((tmp_path / dryrun.record_name(
            "wbpr-maxflow", "graph_16m", "16x16", mode)).read_text())
        assert (rec["graph_mode"], rec["devices"]) == (mode, 8)
    err = tmp_path / "wbpr-maxflow__graph_16m__2x16x16__no-such-mode.err"
    assert "unknown graph mode" in err.read_text()


# ---------------------------------------------------------------------------
# the synthetic slabs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell,mesh", [
    (shapes.ShapeCell("g", "maxflow", 512, 64), tmesh.Mesh((4,), ("m",))),
    (CELL, HOST_MESH)])
def test_synthetic_slabs_form_a_residual_graph(cell, mesh):
    """Each rank's slab, built alone, concatenated over the P ranks: a
    valid residual graph (``rev`` an involution, tails and heads swapped,
    no self-loop, one arc a direction a pair)."""
    meta, _ = dryrun._graph_specs(cell, mesh, "sharded")
    p, vs, amax, n = meta.nshards, meta.vs, meta.amax, meta.n
    slabs = [dryrun.rank_slab(meta, w, torch.device("cpu"))
             for w in range(p)]
    heads = torch.cat([g.heads for g in slabs]).long().numpy()
    rev = torch.cat([g.rev for g in slabs]).long().numpy()
    tails = np.concatenate([w * vs + g.tail_local.long().numpy()
                            for w, g in enumerate(slabs)])
    ids = np.arange(p * amax)
    assert rev.min() >= 0 and rev.max() < p * amax
    assert np.array_equal(rev[rev], ids)
    assert np.array_equal(heads[rev], tails)
    assert np.array_equal(tails[rev], heads)
    assert (heads != tails).all() and heads.max() < n
    assert len(set(zip(tails.tolist(), heads.tolist()))) == p * amax
    for g in slabs:
        d = amax // vs
        assert torch.equal(g.indptr, torch.arange(vs + 1,
                                                  dtype=torch.int32) * d)
        # each segment's tails are its own vertex
        assert torch.equal(g.tail_local.long(),
                           torch.arange(vs).repeat_interleave(d))


def test_rank_state_is_seeded_and_mid_solve():
    meta, _ = dryrun._graph_specs(CELL, HOST_MESH, "replicated")
    a = dryrun.rank_state(meta, 1, torch.device("cpu"), seed=3)
    b = dryrun.rank_state(meta, 1, torch.device("cpu"), seed=3)
    c = dryrun.rank_state(meta, 1, torch.device("cpu"), seed=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    res, h, e = a
    assert res.shape == (meta.num_arcs,) and res.dtype == torch.int32
    assert int(res.min()) >= 1 and int(res.max()) <= dryrun.MAX_CAP
    assert int(h[meta.s]) == meta.n and int(e[meta.s]) == int(e[meta.t]) == 0
    share = float((e > 0).float().mean())
    assert 0.2 < share < 0.3


# ---------------------------------------------------------------------------
# collectives against the reference's HLO accounting
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_records():
    return {mode: dryrun.run_cell("wbpr-maxflow", CELL, graph_mode=mode,
                                  mesh=HOST_MESH, device="cpu", reps=2)
            for mode in dryrun.GRAPH_MODES}


@pytest.mark.parametrize("it", ("step", "gr_sweep"))
@pytest.mark.parametrize("mode", dryrun.GRAPH_MODES)
def test_collective_bytes_match_the_reference(reference, port_records,
                                              mode, it):
    got = port_records[mode]["per_iter"][it]["collectives"]
    want = reference["lower"][mode][it]
    if mode == "sparse" and it == "step":
        # the reference's HLO count has no all-to-all; the port's step
        # issues one (P blocks of (2, vs) int32)
        extra = 4 * 8 * 2 * (CELL.batch // 8) * 7 / 8
        assert "all-to-all" not in want["by_op"]
        assert got["by_op"] == {**want["by_op"], "all-to-all": extra}
        assert got["counts"] == {**want["counts"], "all-to-all": 1}
        assert got["total_bytes"] == want["total_bytes"] + extra
        return
    assert got == want
    assert got["by_op"] == port_records[mode]["expected_collectives"][it]


def test_reference_bytes_are_the_known_ones(reference):
    lower = reference["lower"]
    assert lower["replicated"]["step"]["by_op"] == {"all-reduce": 143360.0}
    assert lower["sharded"]["step"]["by_op"] == {"reduce-scatter": 57344.0,
                                                 "all-reduce": 28672.0}
    assert lower["sparse"]["step"]["by_op"] == {"all-reduce": 28672.0}
    assert all(lower[m]["gr_sweep"]["by_op"] == {"all-reduce": 14336.0}
               for m in dryrun.GRAPH_MODES)


@pytest.mark.parametrize("mode", dryrun.GRAPH_MODES)
def test_record_fields(port_records, mode):
    rec = port_records[mode]
    assert rec["devices"] == 8 and rec["mesh"] == "2x4"
    assert rec["rank"] == dryrun.RANK and rec["device"] == "cpu"
    assert rec["analytic"] == {"vertices": CELL.batch, "arcs": CELL.seq,
                               "cycles": 64, "est_sweeps": 24}
    step, sweep = rec["per_iter"]["step"], rec["per_iter"]["gr_sweep"]
    assert rec["extrapolated"]["collective_bytes"] == \
        64 * step["collectives"]["total_bytes"] \
        + 24 * sweep["collectives"]["total_bytes"]
    assert step["launches"] == sweep["launches"] == 0
    assert rec["full"]["kernel_launches"] == 0
    assert step["aten_ops"] > 0 and step["device_ms"] is None
    assert rec["full"]["memory"]["peak_allocated_bytes"] is None
    mem = rec["full"]["memory"]
    assert mem["state_bytes"] == sum(mem["state"].values())
    assert mem["state"]["res"] == 4 * (CELL.seq if mode == "replicated"
                                       else CELL.seq // 8)
    assert rec["graph"]["active_on_rank"] > 0
    sup = rec["full"]["superstep"]
    assert sup["cycles"] == 64 and sup["local_fixpoint_sweeps"] >= 1
    assert not dist.is_initialized()


def test_cli_writes_a_graph_16m_record(tmp_path):
    """One production cell through the CLI on the CPU: graph_16m at
    16x16, replicated (rank 1 of 256: 64 MiB of residual)."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "wbpr-maxflow", "--shape", "graph_16m", "--device", "cpu",
         "--out-dir", str(tmp_path)], env=ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / "wbpr-maxflow__graph_16m__16x16.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "devices", "kind", "graph_mode",
                "skipped", "analytic", "per_iter", "extrapolated", "full"):
        assert key in rec
    assert (rec["shape"], rec["mesh"], rec["devices"], rec["graph_mode"],
            rec["skipped"]) == ("graph_16m", "16x16", 256, "replicated",
                                False)
    meta, _ = dryrun._graph_specs(shapes.GRAPH_SHAPES["graph_16m"],
                                  tmesh.production_mesh(False), "replicated")
    assert rec["meta"] == dataclasses.asdict(meta)
    assert rec["per_iter"]["step"]["collectives"]["by_op"] == \
        dryrun.expected_collectives(meta)["step"] == {
            "all-reduce": 2 * 4 * (2**24 + 2**22) * 255 / 256}


# ---------------------------------------------------------------------------
# the language-model cells
# ---------------------------------------------------------------------------

LM_MESH = tmesh.Mesh((2, 2), ("data", "model"))


@pytest.fixture(scope="module")
def lm_record():
    """qwen3-4b SMOKE at 3 superblocks, a decode cell of 8 x 64 on a
    (2, 2) mesh under the fake group, with the whole depth run too."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen3-4b"),
                              n_layers=3)
    cell = shapes.ShapeCell("decode_small", "decode", 64, 8)
    return cfg, dryrun.run_cell("qwen3-4b", cell, mesh=LM_MESH, cfg=cfg,
                                device="cpu", reps=1, full_depth=True)


def test_lm_record_fields(lm_record):
    """The record has the reference's fields (``arch``, ``shape``,
    ``mesh``, ``devices``, ``kind``, ``skipped``, ``opt``, ``analytic`` by
    the reference's formula, ``extrapolated.{flops,collective_bytes}``)
    and the port's (``full.memory`` from the shape trees, the variants'
    costs, the device and torch); no kernel launched, the group closed."""
    cfg, rec = lm_record
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["devices"],
            rec["kind"], rec["skipped"], rec["opt"]) == (
        "qwen3-4b", "decode_small", "2x2", 4, "decode", False, None)
    assert rec["analytic"] == {
        "params": cfg.param_count(), "active_params":
            cfg.active_param_count(), "tokens": 8,
        "model_flops": 2 * cfg.active_param_count() * 8}
    mem = rec["full"]["memory"]["arg_bytes"]
    assert mem["total"] == mem["params"] + mem["cache"] + mem["batch"] > 0
    # the cache: 3 blocks x k, v x 4 rows x 32 slots x 2 kv heads x 16 x 4 B
    assert mem["cache"] == 4 + 2 * 3 * 4 * 32 * 2 * 16 * 2
    for k in ("c1", "c2"):
        v = rec["variant_costs"][k]
        assert v["flops"] > 0 and v["kernel_launches"] == 0
        assert v["device_ms"] is None and v["aten_ops"] > 0
    assert rec["device"] == "cpu" and rec["torch"] == torch.__version__
    assert not dist.is_initialized()


def test_lm_extrapolation_equals_the_whole_run(lm_record):
    """``C1 + (n_blocks - 1)(C2 - C1)`` of the 1- and 2-superblock runs
    equals the 3-superblock run exactly in flops, collective bytes (in
    all and by kind) and aten ops."""
    _, rec = lm_record
    e, f = rec["extrapolated"], rec["full_run"]
    assert f["n_layers"] == 3
    assert e["flops"] == f["flops"] > 0
    assert e["collective_bytes"] == f["collectives"]["total_bytes"] > 0
    assert {k: v for k, v in e["collective_bytes_by_op"].items() if v} == \
        f["collectives"]["by_op"]
    assert e["aten_ops"] == f["aten_ops"]
