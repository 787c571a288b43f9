"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's ``launch/dryrun.py`` and ``core/distributed.py``.

``DistributedPgbsc``'s abstract mode takes the reference's shapes: the
widths, padded widths, split tables and eMA forms of its plan, its block
and padded vertex count and its edge slots, held to the reference's
``DistributedPgbsc(None, ...)`` on a (2, 2) mesh of 4 forced host
devices (one JAX subprocess). The PGBSC dry run at full size traces the
walk through the gather SpMM and eMA ops: its flops are the analytic
nnz-based sum over rank 0's shard of the plan's nodes, its collectives
the count the ring and the eMA forms give. The model cells: one reduced
cell of each family traces on a (2, 2) fake mesh; on a (1, 1) mesh its
flops equal ``FlopCounterMode`` over the same step on real CPU tensors.
``TestDryrunArtifacts`` reads ``results/dryrun_torch`` when a grid run
left it there.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import hlo
from repro_torch.analysis.roofline import spmm_ema_flops
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core import executor as pexec
from repro_torch.core.distributed import DistributedPgbsc
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import dryrun as dr
from repro_torch.train import step as st

SRC = str(Path(__file__).resolve().parents[1] / "src")
RESULTS = os.path.join(os.path.dirname(__file__), "..", "results",
                       "dryrun_torch")
REF_KEYS = {"ok", "compile_s", "memory", "roofline", "collectives",
            "hlo_ops", "model_flops_global", "model_flops_per_device",
            "useful_flops_ratio", "arch", "cell", "mesh", "chips", "wall_s"}
ABSTRACT = {"n": 5_000, "e": 120_000}
PLANS = ("plain", "dedup", "optimized")


def _abstract(template, plan, shape=(2, 2), dims=ABSTRACT):
    """The port's abstract DistributedPgbsc as rank 0 of a fake group."""
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    world = 1
    for s in shape:
        world *= s
    with dr.fake_world(world):
        mesh = dr._mesh(shape, axes, torch.device("cuda"))
        with FakeTensorMode():
            return DistributedPgbsc(None, template, mesh, plan=plan,
                                    abstract_dims=dims)


_REF = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
from repro.core.distributed import DistributedPgbsc
from repro.core.templates import get_template
from repro.launch.mesh import make_mesh
dims, plans = json.loads(sys.argv[1])
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for t in ("u5", "u12"):
    for plan in plans:
        d = DistributedPgbsc(None, get_template(t), mesh, plan=plan,
                             abstract_dims=dims)
        meta = []
        for m in d.meta:
            form = None
            if m.ia is not None:
                a_pad = d.meta[m.active].width_pad
                p_pad = d.meta[m.passive].width_pad
                form = ("scatter" if p_pad + 2 * m.width_pad < a_pad + p_pad
                        else "gather")
            meta.append([m.width, m.width_pad, m.active, m.passive, form,
                         None if m.ia is None else m.ia.tolist(),
                         None if m.ip is None else m.ip.tolist()])
        out[f"{t}/{plan}"] = {
            "n_pad": d.n_pad, "block": d.block, "n_true": d.n_true,
            "edges": list(d.edge_arrays["src_local"].shape), "meta": meta}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference_layouts():
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _REF,
                          json.dumps([ABSTRACT, PLANS])],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("tname", ["u5", "u12"])
def test_abstract_shard_plan_equals_reference(reference_layouts, tname,
                                              plan):
    ref = reference_layouts[f"{tname}/{plan}"]
    d = _abstract(tname, plan)
    assert (d.n_pad, d.block, d.n_true) == (ref["n_pad"], ref["block"],
                                            ref["n_true"])
    # one gather operand a source block, the reference's edge slots each
    assert [p.src.numel() for p in d.ring_preps] == [ref["edges"][2]] * 2
    assert len(ref["edges"]) == 3 and ref["edges"][:2] == [2, 2]
    got = [[m.width, m.width_pad, m.active, m.passive, m.collective,
            None if m.ia is None else m.ia.tolist(),
            None if m.ip is None else m.ip.tolist()] for m in d.meta]
    assert got == ref["meta"]


def test_abstract_operands_are_the_real_modes_shapes():
    from repro_torch.graph.generators import grid_2d
    from repro_torch.core.distributed import build_ring_edges
    g = grid_2d(40, 40)
    src, _ = g.edges_by_dst
    d = _abstract("u5", "dedup", shape=(1, 1),
                  dims={"n": g.n, "e": len(src), "e_max": len(src)})
    ring = build_ring_edges(g, 1)
    assert (d.n_pad, d.block) == (ring["n_pad"], ring["block"])
    with dr.fake_world(1):
        real = DistributedPgbsc(g, "u5", dr._mesh((1, 1), ("data", "model"),
                                                  torch.device("cpu")),
                                plan="dedup")
    shapes = [(tuple(t.shape), t.dtype) for t in d.operands()]
    assert shapes == [(tuple(t.shape), t.dtype) for t in real.operands()]


def test_abstract_mode_needs_dims_and_a_fake_mode_without_a_card():
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh
    with dr.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"))   # CUDA, no card needed
        with pytest.raises(ValueError, match="abstract_dims"):
            DistributedPgbsc(None, "u3", mesh)
    with FakeTensorMode():
        assert resolve_device().type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


# ------------------------------------------------------- the PGBSC cells
def _walk(dpg):
    """(SpMMs run, eMA nodes run) of one plan walk, in the executor's
    order with its passive cache (the walk the trace takes)."""
    spmm, ema = [], []
    runner = pexec.PlanExecutor(dpg.plan, dpg.exec_schedule)
    runner.run(object(),
               passive_op=lambda p, m: spmm.append(p) or object(),
               combine=lambda i, a, y: ema.append(i) or object())
    return spmm, ema


@pytest.fixture(scope="module")
def rmat1m_u7():
    return dr.run_cell("pgbsc", "rmat1m_u7", "single")


def test_pgbsc_cell_is_ok_with_the_references_keys(rmat1m_u7):
    rec = rmat1m_u7
    assert rec["ok"] and REF_KEYS <= set(rec)
    assert (rec["arch"], rec["cell"], rec["mesh"], rec["chips"]) == (
        "pgbsc", "rmat1m_u7", "single", 256)
    r = rec["roofline"]
    assert min(r["flops"], r["bytes"], r["collective_bytes"]) > 0
    assert rec["memory"]["generated_code_bytes"] is None
    assert rec["extrapolation"] is None
    assert rec["hlo_ops"]["custom-call"] > 0 and rec["hlo_ops"]["dot"] == 0
    assert min(rec["memory"]["argument_bytes"],
               rec["memory"]["temp_bytes"]) > 0


def test_pgbsc_flops_are_the_analytic_sum_over_rank_zeros_shard(rmat1m_u7):
    spec = dr.PGBSC_CELLS["rmat1m_u7"]
    dpg = _abstract(spec["template"], "dedup", shape=(16, 16),
                    dims={"n": spec["n"], "e": spec["e"]})
    e_rank = sum(p.src.numel() for p in dpg.ring_preps)
    spmm, ema = _walk(dpg)
    d_model = dpg.d_model
    want = 0
    for p in spmm:      # each SpMM on my slice of the passive's rows
        want += spmm_ema_flops(1, e_rank, dpg.block,
                               dpg.meta[p].width_pad // d_model, 0, 0)
    for i in ema:       # the eMA on my split tables' rows
        ia, _ = dpg.splits[i]
        s, l = ia.shape
        want += spmm_ema_flops(1, e_rank, dpg.block, 0, s, l)
        assert s == (dpg.meta[i].width_pad // d_model
                     if dpg.meta[i].collective == "gather"
                     else dpg.meta[i].width_pad)
    assert rmat1m_u7["roofline"]["flops"] == want


def test_pgbsc_collectives_are_the_rings_and_the_forms(rmat1m_u7):
    dpg = _abstract("u7", "dedup", shape=(16, 16),
                    dims={"n": 1_000_000, "e": 400_000_000})
    spmm, ema = _walk(dpg)
    forms = [dpg.meta[i].collective for i in ema]
    gather, scatter = forms.count("gather"), forms.count("scatter")
    counts = {k: v["count"] for k, v in rmat1m_u7["collectives"].items()}
    assert counts == {
        # the ring: d_data - 1 transfers a SpMM
        "collective-permute": (dpg.d_data - 1) * len(spmm),
        # both children of a gather-form node, the passive of a scatter
        "all-gather": 2 * gather + scatter,
        "reduce-scatter": scatter,
        # the coloring's sum over data, then over model
        "all-reduce": 2}
    block = dpg.block * 4
    assert rmat1m_u7["collectives"]["collective-permute"]["bytes"] == sum(
        (dpg.d_data - 1) * dpg.meta[p].width_pad // dpg.d_model * block
        for p in spmm)


def test_pgbsc_multi_mesh_runs_one_pod_walk():
    rec = dr.run_cell("pgbsc", "gs20_u5", "multi")
    single = dr.run_cell("pgbsc", "gs20_u5", "single")
    assert rec["ok"] and rec["chips"] == 512
    # a pod is the single mesh: the same walk for rank 0
    assert rec["roofline"]["flops"] == single["roofline"]["flops"]
    assert rec["collectives"] == single["collectives"]


def test_main_writes_records_and_fails_loudly(tmp_path, monkeypatch):
    out = tmp_path / "out"
    assert dr.main(["--arch", "pgbsc", "--cell", "gs20_u5", "--mesh",
                    "single", "--out", str(out)]) == 0
    rec = json.loads((out / "pgbsc__gs20_u5__single.json").read_text())
    assert rec["ok"] and not list(out.glob("*.tmp"))

    def boom(*a):
        raise RuntimeError("no strategy")
    monkeypatch.setattr(dr, "run_cell", boom)
    assert dr.main(["--arch", "pgbsc", "--cell", "rmat1m_u7", "--mesh",
                    "single", "--out", str(out), "--skip-existing"]) == 1
    bad = json.loads((out / "pgbsc__rmat1m_u7__single.json").read_text())
    assert not bad["ok"] and "no strategy" in bad["error"]
    assert "Traceback" in bad["traceback"]


# ------------------------------------------------------- the model cells
FAMILY_CELLS = [("smollm-360m", "smoke_train"), ("smollm-360m",
                                                 "smoke_decode"),
                ("graphsage-reddit", "smoke_full"),
                ("nequip", "smoke_molecule"), ("autoint", "smoke_train")]


def _trace_reduced(arch_id, cell, shape):
    arch = reduced_config(arch_id)
    axes = ("data", "model")
    with dr.fake_world(shape[0] * shape[1]):
        dev = hlo.trace_device(autograd=True)
        mesh = dr._mesh(shape, axes, dev)
        return dr.trace_arch(arch, cell, mesh, shape[0] * shape[1], dev)


@pytest.mark.parametrize("arch_id,cell", FAMILY_CELLS)
def test_reduced_cell_traces_on_a_two_by_two_mesh(arch_id, cell):
    rec = _trace_reduced(arch_id, cell, (2, 2))
    assert rec["ok"] and rec["roofline"]["flops"] > 0
    assert rec["collectives"]          # a sharded step moves something
    assert rec["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("arch_id,cell", FAMILY_CELLS)
def test_one_by_one_trace_counts_flop_counter_modes_flops(arch_id, cell):
    arch = reduced_config(arch_id)
    c = arch.cell(cell)
    rec = _trace_reduced(arch_id, cell, (1, 1))
    state = st.concrete_train_state(arch, 0, d_in=c.dims.get("d_feat"),
                                    device="cpu")
    batch = make_batch(arch, cell, 0, device="cpu")
    _, _, statics = dr.input_specs(arch, cell)
    with FlopCounterMode(display=False) as fc:
        if c.kind == "train":
            st.build_train_step(arch, statics=statics,
                                microbatches=dr._microbatches_for(
                                    arch, c))(state, batch)
        else:
            st.build_serve_step(arch, c.kind, statics=statics)(
                state["params"], batch)
    assert rec["roofline"]["flops"] == fc.get_total_flops() > 0


# ------------------------------------------------------------ artifacts
# cells whose traced state and temporaries a rank exceed one H100's 80 GB
# by more than the slack (the grid's records, PERF.md §6); the
# reference's v5e list named its own
_MEMORY_EXEMPT = {
    ("deepseek-moe-16b", "prefill_32k"), ("gemma3-1b", "train_4k"),
    ("llama3-8b", "train_4k"), ("pna", "ogb_products"),
    ("qwen3-moe-30b-a3b", "prefill_32k"), ("qwen3-moe-30b-a3b", "train_4k"),
}
# (arch, cell, mesh) records the grid left ok: false or did not finish,
# each a Queue 3 entry in ROADMAP.md
_KNOWN_FAILURES = {
    ("nequip", "minibatch_lg", "multi"), ("nequip", "ogb_products", "single"),
    ("nequip", "ogb_products", "multi"),
}


@pytest.mark.skipif(not os.path.isdir(RESULTS),
                    reason="dry-run artifacts not present")
class TestDryrunArtifacts:
    def _records(self):
        recs = []
        for f in os.listdir(RESULTS):
            if f.endswith(".json"):
                with open(os.path.join(RESULTS, f)) as fh:
                    recs.append(json.load(fh))
        return recs

    def test_all_cells_present_and_failures_known(self):
        recs = self._records()
        seen = {(r["arch"], r["cell"], r["mesh"]) for r in recs}
        for arch_id in list(ARCH_IDS) + ["pgbsc"]:
            cells = (list(dr.PGBSC_CELLS) if arch_id == "pgbsc" else
                     [c.name for c in get_config(arch_id).cells])
            for cell in cells:
                for mesh in ("single", "multi"):
                    key = (arch_id, cell, mesh)
                    assert key in seen or key in _KNOWN_FAILURES, key
        bad = {(r["arch"], r["cell"], r["mesh"]) for r in recs
               if not r.get("ok")}
        assert bad <= _KNOWN_FAILURES, sorted(bad - _KNOWN_FAILURES)

    def test_roofline_terms_positive(self):
        for r in self._records():
            if not r.get("ok"):
                continue
            rf = r["roofline"]
            assert rf["flops"] > 0
            assert rf["bytes"] > 0
            assert rf["dominant"] in ("compute", "memory", "collective")

    def test_memory_fits_hbm(self):
        # H100: 80 GB a card; arguments + temporaries must fit, with the
        # reference's 1.25x slack
        for r in self._records():
            if not r.get("ok") or (r["arch"], r["cell"]) in _MEMORY_EXEMPT:
                continue
            m = r["memory"]
            total = m["argument_bytes"] + (m["temp_bytes"] or 0)
            assert total < 80e9 * 1.25, \
                (r["arch"], r["cell"], r["mesh"], total / 1e9)
