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
The tracer's closed forms of DTensor's strided-shard bookkeeping equal
DTensor's own, and a big nequip cell traces at any edge count.
``TestDryrunArtifacts`` reads the records in ``results/dryrun_torch`` that
this tree wrote (``tools/dryrun_grid.py``).
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
    # the scatters have sharding rules (train/op_sharding): none runs whole
    assert not [op for op in rec["ran_whole"]
                if any(k in op for k in ("index_add", "scatter_reduce",
                                         "scatter_"))], rec["ran_whole"]


def _wide_lm(vocab: int, seq: int, batch: int):
    """The reduced smollm at ``vocab`` tokens, one train cell."""
    import dataclasses

    from repro_torch.configs import ShapeCell
    arch = reduced_config("smollm-360m")
    return dataclasses.replace(
        arch, model=dataclasses.replace(arch.model, vocab_size=vocab),
        cells=(ShapeCell("wide", "train", {"seq": seq, "batch": batch}),))


def test_lm_train_on_a_split_vocab_holds_no_whole_vocab_logits():
    """The logits dominate a reduced LM at 256x its width in tokens: the
    step's temporaries a rank stay below one replicated ``(B, S, V)`` f32
    tensor of its microbatch, which ``gather``'s backward made on every
    rank (its zeros at the microbatch's global shape)."""
    arch = _wide_lm(vocab=256 * 64, seq=256, batch=16)
    assert arch.model.vocab_size >= 16 * arch.model.d_model
    rows = 16 // dr._microbatches_for(arch, arch.cell("wide"))
    with dr.fake_world(4):
        dev = hlo.trace_device(autograd=True)
        mesh = dr._mesh((2, 2), ("data", "model"), dev)
        rec = dr.trace_arch(arch, "wide", mesh, 4, dev)
    whole_logits = rows * 256 * arch.model.vocab_size * 4
    assert rec["ok"] and rec["ran_whole"] == {}
    assert rec["memory"]["temp_bytes"] < whole_logits


def test_llama3_decode_keeps_the_cache_split_over_the_sequence():
    """A reduced llama3 ``decode_32k`` on a 1 x 2 mesh, with the
    reference's decode hints: the cache arrives split over the sequence
    (argument bytes hold half of it) and no collective moves a layer's
    cache (nothing gathers it)."""
    import dataclasses

    from repro_torch.configs import ShapeCell
    from repro_torch.configs.shapes import decode_hint_specs
    arch = reduced_config("llama3-8b")
    cell = ShapeCell("decode_32k", "decode", {"seq": 512, "batch": 2})
    arch = dataclasses.replace(arch, cells=(cell,))
    m = arch.model
    assert decode_hint_specs(arch, cell)["cache"][1] == "model"
    layer = 2 * 512 * m.n_kv_heads * m.head_dim * 4      # f32, k or v
    with dr.fake_world(2):
        dev = hlo.trace_device(autograd=True)
        mesh = dr._mesh((1, 2), ("data", "model"), dev)
        rec = dr.trace_arch(arch, "decode_32k", mesh, 2, dev)
    assert rec["ok"] and rec["ran_whole"] == {}
    cache = 2 * m.n_layers * layer                      # k and v, whole
    assert rec["memory"]["argument_bytes"] < cache
    assert max(v["bytes"] / v["count"] for v in
               rec["collectives"].values()) < layer / 2


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


# ------------------------------------------ strided shards and the planner
def _strided_api():
    """(DTensor's own ``local_shard_size_and_offset``, the ways it can be
    asked for offsets): torch 2.13's ``offset_mode`` enum, or 2.11's
    ``return_first_offset``."""
    import inspect

    from torch.distributed.tensor import placement_types as pt
    fn = inspect.getattr_static(pt._StridedShard,
                                "local_shard_size_and_offset")
    mode = getattr(pt, "_StridedShardOffsetMode", None)
    return fn, (list(mode) if mode is not None else [True, False])


@pytest.mark.parametrize("num_chunks", [1, 2, 3, 4, 16])
def test_closed_form_strided_sizes_and_offsets_are_dtensors(num_chunks):
    from torch.distributed.tensor.placement_types import _StridedShard
    own, modes = _strided_api()
    closed = hlo._closed_size_and_offset(own)
    checked = 0
    for sf in (1, 2, 3, 5, 14, 16):
        placement = _StridedShard(0, split_factor=sf)
        for size in list(range(0, 41)) + [224, 2560, 4097]:
            for rank in range(num_chunks):
                for how in modes:
                    want = own(placement, size, num_chunks, rank, how)
                    got = closed(placement, size, num_chunks, rank, how)
                    assert tuple(got) == tuple(want), (sf, size, rank, how)
                    checked += 1
    assert checked == 6 * 44 * num_chunks * len(modes)


@pytest.mark.parametrize("dim,sf,num_chunks,shape", [
    (0, 160, 16, (40960, 3, 3)), (1, 14, 16, (2, 224)), (0, 4, 2, (16,)),
    (1, 3, 4, (2, 24, 5)), (0, 1, 4, (8, 2)),
    # uneven: most shards empty; a short last piece; both
    (0, 40, 16, (80, 2, 3)), (0, 3, 4, (10,)), (1, 5, 3, (2, 23))])
def test_strided_split_is_dtensors_split_with_its_kernels(dim, sf,
                                                          num_chunks, shape):
    from torch.distributed.tensor.placement_types import _StridedShard
    placement = _StridedShard(dim, split_factor=sf)
    own = _StridedShard._split_tensor
    closed = hlo._strided_split(own)
    x = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    for pad in (True, False):
        want, want_pad = own(placement, x, num_chunks, with_padding=pad,
                             contiguous=False)
        got, got_pad = closed(placement, x, num_chunks, with_padding=pad,
                              contiguous=False)
        assert got_pad == want_pad
        assert all(torch.equal(a, b) and b.is_contiguous()
                   for a, b in zip(want, got, strict=True))
    # under the trace: the same cat a shard, bytes and memory; DTensor's
    # loop adds only fills of its empty chunks (no kernel on a card; the
    # byte rule counts the chunk ``new_zeros`` is called on)

    def split(fn):
        with FakeTensorMode() as mode:
            fx = torch.empty(shape)
        return hlo.trace_step(lambda t: fn(placement, t, num_chunks)[0], fx,
                              mode=mode)[1]
    a, b = split(own), split(closed)
    fills = [r for r in a.ops if r.name == "aten::new_zeros.default"]
    cats = [(r.name, r.bytes) for r in b.ops if r.kind == "fusion"]
    assert cats == [(r.name, r.bytes) for r in a.ops if r.kind == "fusion"
                    and r not in fills]
    assert len(cats) == num_chunks
    assert a.bytes_accessed - sum(r.bytes for r in fills) == b.bytes_accessed
    assert (a.peak_bytes, a.temp_bytes) == (b.peak_bytes, b.temp_bytes)


def test_split_with_runs_of_two_lengths_is_left_to_dtensor():
    from torch.distributed.tensor.placement_types import _StridedShard
    called = []

    def own(self, tensor, num_chunks, **kw):
        called.append(tuple(tensor.shape))
        return [tensor], []
    closed = hlo._strided_split(own)
    # 7 in 3 pieces of 3, 3, 1, each in 2: shard 0 takes runs of 2 and 1
    closed(_StridedShard(0, split_factor=3), torch.zeros(7), 2)
    closed(_StridedShard(0, split_factor=2), torch.zeros(0), 4)
    assert called == [(7,), (0,)]


def _nequip_big(n, e):
    """The reduced nequip with one cell of ``n`` nodes and ``e`` edges
    (big from ``n = 100,000``: edges sharded over every mesh axis)."""
    import dataclasses

    from repro_torch.configs import ShapeCell
    return dataclasses.replace(reduced_config("nequip"), cells=(
        ShapeCell("big", "train", {"n": n, "e": e, "d_feat": 6}),))


def _trace_big(n, e, shape):
    arch = _nequip_big(n, e)
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    world = 1
    for s in shape:
        world *= s
    with dr.fake_world(world):
        dev = hlo.trace_device(autograd=True)
        mesh = dr._mesh(shape, axes, dev)
        return dr.trace_arch(arch, "big", mesh, world, dev)


def test_nequip_bookkeeping_does_not_grow_with_the_edges():
    """A big nequip cell's edge tensors flatten ``(E, C)`` into a strided
    shard of split factor ``E / 16``: at 100x the edges the trace
    finishes and DTensor's bookkeeping makes no larger real tensor."""
    small = _trace_big(100_000, 25_600, (16, 16))
    large = _trace_big(100_000, 2_560_000, (16, 16))
    assert small["ok"] and large["ok"]
    assert small["bookkeeping_bytes"] == large["bookkeeping_bytes"]
    assert large["roofline"]["flops"] > small["roofline"]["flops"]
    assert large["collectives"]["all-gather"]["bytes"] > \
        small["collectives"]["all-gather"]["bytes"]


def _gather_strided(e, c=16, shape=(16, 16), targets=None):
    """Trace gathering a ``(e * c, 3)`` DTensor held as nequip's edge
    tensors are after ``(E, C)`` flattens: ``e`` split over the leading
    mesh dims, then ``c`` over the last (a strided shard of split factor
    ``e`` over the leading ranks). -> the trace."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    world = 1
    for n in shape:
        world *= n
    lead = world // shape[-1]
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    with dr.fake_world(world):
        mesh = dr._mesh(shape, axes, torch.device("cpu"))
        mode = FakeTensorMode()
        with mode:
            x = DTensor.from_local(
                torch.empty(e * c // world, 3), mesh,
                (Shard(0),) * (len(shape) - 1)
                + (_StridedShard(0, split_factor=e // lead),),
                run_check=False, shape=torch.Size([e * c, 3]),
                stride=(3, 1))
        whole = (Replicate(),) * len(shape)
        return hlo.trace_step(lambda t: [
            t.redistribute(mesh, p).to_local()
            for p in (targets or [whole])], x, mode=mode)[1]


def test_bookkeeping_bytes_see_dtensors_own_arange(monkeypatch):
    """Gathering a strided shard: DTensor's own sizes come from a real
    ``arange`` over the dim (the trace records it, and it grows with the
    dim); with the closed form the largest is the same at any size.
    (torch 2.11's DTensor cannot gather this placement: a 2.13 test.)"""
    assert _gather_strided(2_560).bookkeeping_bytes == \
        _gather_strided(256_000).bookkeeping_bytes < 2_560 * 8
    monkeypatch.setattr(hlo, "_closed_size_and_offset", lambda fn: fn)
    # the model axis's logical size, e * c / 16, as int64
    assert _gather_strided(2_560).bookkeeping_bytes >= 2_560 * 8
    assert _gather_strided(25_600).bookkeeping_bytes >= 25_600 * 8


def test_nequip_minibatch_lg_traces_on_the_multi_pod_mesh():
    cell = get_config("nequip").cell("minibatch_lg").dims
    rec = _trace_big(cell["n"], cell["e"], (2, 16, 16))
    assert rec["ok"] and rec["roofline"]["flops"] > 0
    assert rec["collectives"]["all-gather"]["count"] > 0


def test_planner_memo_keeps_the_plans(monkeypatch):
    """DTensor's graph planner on a 3-D mesh (the one it must take for a
    strided shard), memoized: the same plan for every pair of specs, and
    the memo answers most of the planner's asks."""
    import itertools

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, \
        TensorMeta
    planner = _redistribute.DTensorRedistributePlanner
    own = planner.get_next_state
    calls = {"asked": 0, "built": 0}

    def build(*a):
        calls["built"] += 1
        return own(*a)
    memo = hlo._memo_next_state(build)

    def ask(*a):
        calls["asked"] += 1
        return memo(*a)
    each = [Replicate(), Shard(0), Shard(1), Partial()]
    with dr.fake_world(32):
        mesh = dr._mesh((2, 4, 4), ("pod", "data", "model"),
                        torch.device("cpu"))
        meta = TensorMeta(torch.Size([64, 48]), (48, 1), torch.float32)
        specs = [DTensorSpec(mesh, p, tensor_meta=meta)
                 for p in itertools.product(each, repeat=3)]
        pairs = [(a, b) for a in specs[::3] for b in specs[::4]
                 if Partial() not in b.placements]

        def plans():
            getattr(_redistribute, "clear_redistribute_planner_cache",
                    lambda: None)()
            return [_redistribute._gen_transform_infos_non_cached(
                a, b, use_graph_based_transform=True) for a, b in pairs]
        want = plans()
        monkeypatch.setattr(planner, "get_next_state", ask)
        assert plans() == want
    assert calls["asked"] > 2 * calls["built"] > 0


# ------------------------------------------------------------ artifacts
# cells whose traced state and temporaries a rank exceed one H100's 80 GB
# by more than the slack (the grid's records, PERF.md §6): each is on the
# reference's own list
_MEMORY_EXEMPT = {("nequip", "ogb_products")}


def test_memory_exemptions_are_the_references():
    import ast
    ref = Path(__file__).with_name("test_analysis_and_dryrun.py")
    tree = ast.parse(ref.read_text())
    node = next(n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and any(
                    getattr(t, "id", None) == "_MEMORY_EXEMPT"
                    for t in n.targets))
    assert _MEMORY_EXEMPT <= ast.literal_eval(node)


def _records_of_this_tree(directory):
    """-> (the records in ``directory`` this tree and torch wrote, why the
    others were set aside, or why there are none)."""
    stamp = dr.source_stamp()
    recs, aside = [], {"another tree": 0, "another torch": 0,
                       "no stamp": 0}
    names = sorted(f for f in os.listdir(directory) if f.endswith(".json")) \
        if os.path.isdir(directory) else []
    for f in names:
        with open(os.path.join(directory, f)) as fh:
            rec = json.load(fh)
        src = rec.get("source")
        if src == stamp:
            recs.append(rec)
        elif not isinstance(src, dict):
            aside["no stamp"] += 1
        elif src.get("tree") != stamp["tree"]:
            aside["another tree"] += 1
        else:
            aside["another torch"] += 1
    n = sum(aside.values())
    why = (f"{len(names)} records in {directory}, none of this tree "
           f"({stamp['tree'][:12]}) and torch {stamp['torch']}: "
           f"{n} set aside ("
           + ", ".join(f"{v} of {k}" for k, v in aside.items() if v)
           + "); run tools/dryrun_grid.py") if names else \
        f"no dry-run records in {directory}; run tools/dryrun_grid.py"
    return recs, why


def test_records_of_another_tree_or_torch_are_set_aside(tmp_path):
    stamp = dr.source_stamp()
    for name, src in [("a", stamp), ("b", {**stamp, "tree": "0" * 64}),
                      ("c", {**stamp, "torch": "0.0.0"}),
                      ("d", None)]:
        rec = {"ok": True, "arch": name}
        if src is not None:
            rec["source"] = src
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    recs, _ = _records_of_this_tree(str(tmp_path))
    assert [r["arch"] for r in recs] == ["a"]
    (tmp_path / "a.json").unlink()
    recs, why = _records_of_this_tree(str(tmp_path))
    assert not recs
    assert "3 set aside" in why and "1 of another tree" in why
    assert "1 of another torch" in why and "1 of no stamp" in why


def test_main_stamps_every_record(tmp_path, monkeypatch):
    out = tmp_path / "out"
    assert dr.main(["--arch", "pgbsc", "--cell", "gs20_u5", "--mesh",
                    "single", "--out", str(out)]) == 0
    path = out / "pgbsc__gs20_u5__single.json"
    rec = json.loads(path.read_text())
    assert rec["source"] == dr.source_stamp()
    assert rec["source"]["torch"] == torch.__version__
    assert len(rec["source"]["tree"]) == 64
    assert _records_of_this_tree(str(out))[0] == [rec]
    # --skip-existing keeps this tree's record, reruns another's

    def boom(*a):
        raise RuntimeError("ran")
    monkeypatch.setattr(dr, "run_cell", boom)
    args = ["--arch", "pgbsc", "--cell", "gs20_u5", "--mesh", "single",
            "--out", str(out), "--skip-existing"]
    assert dr.main(args) == 0
    path.write_text(json.dumps({**rec, "source": {**rec["source"],
                                                  "torch": "0"}}))
    assert dr.main(args) == 1
    bad = json.loads(path.read_text())
    assert not bad["ok"] and bad["source"] == dr.source_stamp()


def test_tree_hash_names_the_package_contents_only(tmp_path):
    import shutil
    pkg = tmp_path / "src" / "repro_torch"
    shutil.copytree(dr.PACKAGE, pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    outside = tmp_path / "src" / "repro" / "x.py"
    outside.parent.mkdir()
    outside.write_text("a = 1\n")
    before = dr.tree_hash(pkg)
    assert before == dr.tree_hash(dr.PACKAGE)
    outside.write_text("a = 2\n")
    (tmp_path / "README.md").write_text("touched\n")
    (pkg / "__pycache__").mkdir(exist_ok=True)
    (pkg / "__pycache__" / "y.pyc").write_bytes(b"\0")
    assert dr.tree_hash(pkg) == before
    (pkg / "device.py").write_text((pkg / "device.py").read_text() + "\n")
    assert dr.tree_hash(pkg) != before


class TestDryrunArtifacts:
    """The grid's records in ``results/dryrun_torch`` that this tree and
    torch wrote (their ``source`` stamp), held to the reference's rule:
    every (arch, cell, mesh) present and ``ok``. With none, it skips and
    says how many records it set aside and why."""

    @pytest.fixture(scope="class")
    def records(self):
        recs, why = _records_of_this_tree(RESULTS)
        if not recs:
            pytest.skip(why)
        return recs

    def test_all_cells_present_and_failures_known(self, records):
        # no failure is known: every cell of the grid present and ok
        seen = {(r["arch"], r["cell"], r["mesh"]) for r in records}
        for arch_id in list(ARCH_IDS) + ["pgbsc"]:
            cells = (list(dr.PGBSC_CELLS) if arch_id == "pgbsc" else
                     [c.name for c in get_config(arch_id).cells])
            for cell in cells:
                for mesh in ("single", "multi"):
                    assert (arch_id, cell, mesh) in seen, \
                        (arch_id, cell, mesh)
        bad = [(r["arch"], r["cell"], r["mesh"]) for r in records
               if not r.get("ok")]
        assert not bad, bad

    def test_roofline_terms_positive(self, records):
        for r in records:
            rf = r["roofline"]
            assert rf["flops"] > 0
            assert rf["bytes"] > 0
            assert rf["dominant"] in ("compute", "memory", "collective")

    def test_memory_fits_hbm(self, records):
        # H100: 80 GB a card; arguments + temporaries must fit, with the
        # reference's 1.25x slack
        for r in records:
            if (r["arch"], r["cell"]) in _MEMORY_EXEMPT:
                continue
            m = r["memory"]
            total = m["argument_bytes"] + (m["temp_bytes"] or 0)
            assert total < 80e9 * 1.25, \
                (r["arch"], r["cell"], r["mesh"], total / 1e9)
