"""The port's step analysis (``repro_torch.analysis``) against the JAX
package's ``analysis/``.

The reference parses collectives out of HLO text; the port logs the
collectives rank 0 runs on a fake process group. The same conventions
give the same bytes: ``TestHloParser::test_sync_forms``'s numbers, here
from real ``torch.distributed`` calls on fake tensors. Per-rank counting:
a matmul row-sharded four ways counts a quarter of its global flops
(``FlopCounterMode`` counts them all on DTensors). ``RooflineTerms``
given the reference's peaks is the reference's, key for key; the report
and the merge take the same records to the same tables and files.
"""

import json
import os
import random

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
import torch.distributed as dist

from repro.analysis import merge_results as ref_merge
from repro.analysis import report as ref_report
from repro.analysis import roofline as ref_roofline
from repro_torch.analysis import hlo
from repro_torch.analysis import merge_results, report
from repro_torch.analysis.roofline import (H100_SXM, RooflineTerms,
                                           roofline_from_trace,
                                           spmm_ema_flops)
from repro_torch.kernels.ema import ops as ema_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.launch.dryrun import fake_world

CUDA = torch.device("cuda", 0)


def _fake(shape, dtype=torch.float32, device=CUDA):
    return torch.empty(shape, dtype=dtype, device=device)


# ------------------------------------------------------------ collectives
def _traced(world, fn):
    """``fn(mesh)`` traced on a ``world``-rank fake group as rank 0."""
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(world):
        mesh = init_device_mesh("cuda", (world // 4, 4),
                                mesh_dim_names=("data", "model"))
        mode = FakeTensorMode()
        return hlo.trace_step(fn, mesh, mode=mode)[1]


def _sync_forms(mesh):
    """The ops of the reference's ``test_sync_forms``, as collectives."""
    x, y = _fake((2, 8)), _fake((2, 8))
    for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1),
                                     dist.P2POp(dist.irecv, y, 15)]):
        r.wait()
    dist.all_gather_into_tensor(_fake((16, 4), torch.bfloat16),
                                _fake((4, 4), torch.bfloat16),
                                group=mesh.get_group("model"))
    dist.all_reduce(_fake(128))
    dist.reduce_scatter_tensor(_fake(4), _fake(32),
                               group=dist.new_group(list(range(8))))
    return x.add(y)


@pytest.fixture(scope="module")
def sync_trace():
    return _traced(16, _sync_forms)


@pytest.mark.parametrize("kind,count,nbytes", [
    ("collective-permute", 1, 2 * 8 * 4),     # f32[2,8]: one pair, once
    ("all-gather", 1, 16 * 4 * 2),            # its gathered bf16[16,4]
    ("all-reduce", 1, 128 * 4),               # f32[128]
    ("reduce-scatter", 1, 4 * 4 * 8),         # f32[4] times a group of 8
])
def test_collective_conventions_are_the_references(sync_trace, kind, count,
                                                   nbytes):
    s = hlo.collective_summary(sync_trace)
    assert s[kind] == {"count": count, "bytes": nbytes}


def test_an_add_is_no_collective_and_kinds_are_the_references(sync_trace):
    s = hlo.collective_summary(sync_trace)
    assert set(s) == {"collective-permute", "all-gather", "all-reduce",
                      "reduce-scatter"}
    assert set(s) <= set(hlo.COLLECTIVE_KINDS)
    assert hlo.collective_bytes(sync_trace) == 64 + 128 + 512 + 128
    assert hlo.count_ops(sync_trace)["fusion"] == 1       # the add
    # the send of the pair is logged but counts as no collective
    assert [r.name for r in sync_trace.ops].count("c10d::send.default") == 1


# ------------------------------------------------------ per-rank counting
def test_row_sharded_matmul_counts_rank_zeros_quarter():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(4):
        mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("model",))
        mode = FakeTensorMode()
        with mode:
            a = DTensor.from_local(_fake((16, 32)), mesh, [Shard(0)],
                                   run_check=False)
            b = DTensor.from_local(_fake((32, 16)), mesh, [Replicate()],
                                   run_check=False)
            with FlopCounterMode(display=False) as fc:
                a @ b
        out, trace = hlo.trace_step(lambda a, b: a @ b, a, b, mode=mode)
    assert fc.get_total_flops() == 2 * 64 * 32 * 16       # the trap
    assert trace.flops == 2 * 16 * 32 * 16 == 16_384
    assert hlo.count_ops(trace) == {"fusion": 0, "custom-call": 0,
                                    "convolution": 0, "dot": 1}
    assert tuple(out.shape) == (64, 16)


def test_count_ops_kinds_views_and_allocations():
    def step(x, w, k):
        y = x @ w                               # dot
        z = torch.nn.functional.conv1d(y[None], k)   # convolution
        v = y.t().reshape(-1)                   # a copy, then a view
        return z.relu(), v.sum(), torch.empty(3, device=x.device)
    mode = FakeTensorMode()
    with mode:
        args = (_fake((4, 8), device="cpu"), _fake((8, 6), device="cpu"),
                _fake((2, 4, 3), device="cpu"))
    _, trace = hlo.trace_step(step, *args, mode=mode)
    # the copy, relu and sum
    assert hlo.count_ops(trace) == {"fusion": 3, "custom-call": 0,
                                    "convolution": 1, "dot": 1}
    kinds = {r.kind for r in trace.ops}
    assert {"view", "alloc"} <= kinds
    assert all(r.bytes == 0 for r in trace.ops
               if r.kind in ("view", "alloc"))


def test_bytes_and_memory_follow_the_stated_rules():
    def step(x):
        y = x + 1.0
        z = y * 2.0
        del y
        return z.sum()
    mode = FakeTensorMode()
    with mode:
        x = _fake((256, 64), device="cpu")
    nb = 256 * 64 * 4
    out, trace = hlo.trace_step(step, x, mode=mode)
    # each kernel: its inputs' and outputs' bytes
    assert trace.bytes_accessed == 2 * nb + 2 * nb + (nb + 4)
    assert trace.argument_bytes == nb
    assert trace.peak_bytes == 3 * nb          # x, y and z live at once
    assert trace.temp_bytes == 2 * nb
    assert trace.output_bytes == 4


# ------------------------------------------------- the kernels as ops
def _gather_fake_prep(n, e, n_seg=0):
    return spmm_ops.GatherPrep(
        n=n, src=_fake(e, torch.int32), row_ptr=_fake(n + 1, torch.int64),
        tile_ptr=_fake(-(-n // 128) + 1, torch.int64), tile=128,
        hub_degree=spmm_ops.HUB_DEGREE,
        hub_vertex=_fake(n_seg // 2, torch.int32),
        hub_seg_ptr=_fake(n_seg // 2 + 1, torch.int32),
        seg=_fake((n_seg, 2), torch.int64))


@pytest.mark.parametrize("b,c_a,c_p,s,l,n,e,n_seg,dtype", [
    (1, 4, 6, 15, 6, 300, 1800, 0, torch.float32),
    (3, 10, 10, 45, 9, 257, 1000, 6, torch.bfloat16),
])
def test_kernel_ops_trace_on_fake_cuda_with_the_references_flops(
        b, c_a, c_p, s, l, n, e, n_seg, dtype):
    launches = (spmm_ops.spmm_gather.launches, ema_ops.ema.launches)
    mode = FakeTensorMode()
    with mode:
        prep = _gather_fake_prep(n, e, n_seg)
        m_p = _fake((b, c_p, n), dtype)
        m_a = _fake((b, c_a, n), dtype)
        ia, ip = _fake((s, l), torch.int32), _fake((s, l), torch.int32)

    def step(m_a, m_p):
        return ema_ops.ema(m_a, spmm_ops.spmm_gather(m_p, prep), ia, ip)
    out, trace = hlo.trace_step(step, m_a, m_p, mode=mode)
    assert (tuple(out.shape), out.dtype, out.device) == ((b, s, n), dtype,
                                                         CUDA)
    assert trace.flops == spmm_ema_flops(b, e, n, c_p, s, l)
    assert [r.name for r in trace.ops if r.kind == "custom-call"] == [
        "repro_torch::spmm_gather.default", "repro_torch::ema.default"]
    # the gather kernel's scratch is allocated before the op, so the
    # temporary bytes hold it beside the SpMM's output; then the eMA's
    # output and its split-pair scratch beside that
    item = torch.empty((), dtype=dtype).element_size()
    y, z = b * c_p * n * item, b * s * n * item
    pairs = s * ((l + 1) // 2) * 16
    assert trace.temp_bytes == max(prep.scratch_bytes(dtype) + y,
                                   y + z + pairs)
    # nothing launched
    assert (spmm_ops.spmm_gather.launches, ema_ops.ema.launches) == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_ops_fake_outputs_are_the_plain_versions_shapes(dtype):
    from repro_torch.graph.generators import erdos_renyi
    g = erdos_renyi(200, 4.0, seed=3)
    rng = np.random.default_rng(0)
    prep = spmm_ops.prepare(g, "gather", device="cpu")
    m = torch.as_tensor(rng.random((2, 5, g.n), np.float32)).to(dtype)
    ia = torch.as_tensor(rng.integers(0, 5, (7, 3)), dtype=torch.int32)
    y = spmm_ops.spmm_gather(m, prep)
    z = ema_ops.ema(m, y, ia, ia)
    with FakeTensorMode():
        fm = _fake(tuple(m.shape), dtype)
        fp = _gather_fake_prep(g.n, int(prep.src.numel()), prep.n_segments)
        fy = spmm_ops.spmm_gather(fm, fp)
        fz = ema_ops.ema(fm, fy, _fake((7, 3), torch.int32),
                         _fake((7, 3), torch.int32))
    assert (fy.shape, fy.dtype) == (y.shape, y.dtype)
    assert (fz.shape, fz.dtype) == (z.shape, z.dtype)


# ------------------------------------------------------------- indexing
@pytest.mark.parametrize("index", [
    (0,), (slice(1, 3),), (Ellipsis, 1), (None, slice(None), 2),
    (slice(None), None, Ellipsis), (1, Ellipsis, slice(0, 4, 2)),
    (slice(None), [0, 2]), (Ellipsis, [1, 0], slice(1, 3)),
    ([2, 0], 1), (Ellipsis, None),
])
def test_aten_indexing_equals_torch_indexing(index):
    x = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5)
    torch_index = tuple(torch.tensor(i) if isinstance(i, list) else i
                        for i in index)
    view, tensors = hlo._basic_index(x, index)
    got = torch.ops.aten.index.Tensor(view, tensors) if tensors else view
    torch.testing.assert_close(got, x[torch_index], rtol=0, atol=0)
    y = x.clone()
    hlo._aten_item(torch.Tensor.__setitem__, y, index, -1.0)
    want = x.clone()
    want[torch_index] = -1.0
    torch.testing.assert_close(y, want, rtol=0, atol=0)


# --------------------------------------------------------------- roofline
@pytest.mark.parametrize("flops,nbytes,coll,chips", [
    (197e12, 819e9, 0.0, 1), (1.0, 1.0, 50e9, 1),
    (3.5e14, 2.0e12, 7.0e10, 256), (0.0, 0.0, 0.0, 512),
])
def test_roofline_terms_given_the_references_peaks_are_the_references(
        flops, nbytes, coll, chips):
    ours = RooflineTerms(flops, nbytes, coll, chips,
                         peak_flops=ref_roofline.PEAK_FLOPS,
                         mem_bw=ref_roofline.HBM_BW,
                         link_bw=ref_roofline.ICI_BW)
    ref = ref_roofline.RooflineTerms(flops=flops, bytes_accessed=nbytes,
                                     collective_bytes=coll, chips=chips)
    assert ours.as_dict() == ref.as_dict()
    assert ours.compute_fraction == ref.compute_fraction


def test_roofline_defaults_to_the_cards_data_sheet():
    t = RooflineTerms(989.5e12, 3.35e12, 450e9, 1)
    assert (t.peak_flops, t.mem_bw, t.link_bw) == (
        H100_SXM.flops, H100_SXM.mem_bw, H100_SXM.link_bw)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0)
    trace = hlo.StepTrace(ops=[hlo.OpRecord("aten::mm.default", "dot",
                                            flops=10, bytes=20),
                               hlo.OpRecord("c10d::allreduce_.default",
                                            "all-reduce", bytes=8,
                                            collective_bytes=4)])
    r = roofline_from_trace(trace, 16)
    assert (r.flops, r.bytes_accessed, r.collective_bytes, r.chips) == (
        10, 28, 4, 16)


# ----------------------------------------------------- report and merge
def _records(seed):
    rng = random.Random(seed)
    recs = []
    for arch in ("pgbsc", "llama3-8b", "autoint", "pna"):
        for cell in ("train_4k", "decode_32k", "rmat1m_u7", "ogb_products",
                     "serve_bulk"):
            for mesh in ("single", "multi"):
                if rng.random() < 0.15:
                    recs.append({"ok": False, "arch": arch, "cell": cell,
                                 "mesh": mesh, "error": "RuntimeError('x')"})
                    continue
                terms = RooflineTerms(rng.uniform(1e9, 1e15),
                                      rng.uniform(1e9, 1e12),
                                      rng.uniform(0, 1e11), 256)
                recs.append({
                    "ok": True, "arch": arch, "cell": cell, "mesh": mesh,
                    "compile_s": round(rng.uniform(0, 100), 1),
                    "roofline": terms.as_dict(),
                    "useful_flops_ratio": rng.choice([None, 0.5, 1.25]),
                    "memory": {"argument_bytes": rng.randrange(1 << 36),
                               "output_bytes": rng.randrange(1 << 30),
                               "temp_bytes": rng.choice([None, 1 << 33]),
                               "generated_code_bytes": None}})
    return recs


def _strip_notes(table: str) -> list:
    return [row.rsplit("|", 2)[0] for row in table.splitlines()]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_tables_equal_the_references_but_the_notes(seed):
    recs = _records(seed)
    for mesh in ("single", "multi"):
        assert _strip_notes(report.roofline_table(recs, mesh)) == \
            _strip_notes(ref_report.roofline_table(recs, mesh))
        assert report.memory_table(recs, mesh) == \
            ref_report.memory_table(recs, mesh)
    assert report.summary(recs) == ref_report.summary(recs)
    notes = {report.bottleneck_note(r) for r in recs if r.get("ok")}
    assert not any("VMEM" in n or "Pallas" in n for n in notes)


def test_report_main_reads_a_directory(tmp_path, capsys):
    for i, r in enumerate(_records(3)):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    report.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert "16x16 (256 ranks)" in out and "2x16x16 (512 ranks)" in out


def test_merge_results_writes_the_references_files(tmp_path, monkeypatch):
    dirs = []
    for d, recs in enumerate((_records(4), _records(5))):
        path = tmp_path / f"in{d}"
        path.mkdir()
        for r in recs[: 12 + d * 5]:
            arch = "pgbsc-opt" if d and r["arch"] == "pgbsc" else r["arch"]
            (path / f"{arch}__{r['cell']}__{r['mesh']}.json").write_text(
                json.dumps({**r, "from": d}))
        dirs.append(str(path))
    dirs.append(str(tmp_path / "missing"))
    merge_results.main(dirs + ["--out", str(tmp_path / "ours")])
    monkeypatch.setattr("sys.argv", ["merge"] + dirs
                        + ["--out", str(tmp_path / "ref")])
    ref_merge.main()
    ours = {f: (tmp_path / "ours" / f).read_text()
            for f in os.listdir(tmp_path / "ours")}
    ref = {f: (tmp_path / "ref" / f).read_text()
           for f in os.listdir(tmp_path / "ref")}
    assert ours == ref and any("pgbsc__" in f for f in ours)
