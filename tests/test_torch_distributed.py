"""Distributed PGBSC on ``torch.distributed`` against the JAX package's
``core/distributed.py``.

In-process checks hold the host-side pieces against the reference array
for array: the ring's edge arrays, the colorings of a stream id, each
plan node's padded split tables and eMA form over ``model``; the pod
rounds; the scatter eMA's remapped split tables against a direct
evaluation of the reference's masked sum; and the directed gather operand
against a dense product.

One run of 8 gloo ranks (``FileStore`` under ``tmp_path``, each rank a
fresh interpreter) counts every (mesh, template, plan) case and drives the
runner; one JAX process on 8 forced host devices counts the same cases
through the reference. Each case's per-iteration sums must be equal on
every rank and mesh, to the JAX package's, and to the port's single-device
gather engine on the same colorings — exactly: the tables hold integers.
Every subprocess has its own timeout, so a hung rank fails the run.
"""

import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import distributed as ref_dist  # noqa: E402
from repro.core.templates import get_template as ref_get_template  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro_torch.core import count_subgraphs_exact, get_template  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core.colorsets import colorful_probability  # noqa: E402
from repro_torch.core.engines import CountingEngine  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels.ema import ops as ema_ops  # noqa: E402
from repro_torch.kernels.spmm import ops as spmm_ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.ranks import run_all  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLD = 8
TIMEOUT_S = 300
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
TEMPLATES = ("u3", "u5", "u7", "path5")
PLANS = ("plain", "dedup", "optimized")
ITERS, SEED = (0, 1, 2, 3), 5
# a graph that spreads over every data shard of the meshes (block 128 at
# 8 shards, 256 at 4, 384 at 2), so the ring moves real tables; both
# packages' generators make it from this spec
SUMS_GRAPH = ("erdos_renyi", (600, 6.0), {"seed": 4})


@pytest.fixture(autouse=True)
def _partitionable():
    """The port's coloring stream is partitionable threefry's."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


# ----------------------------------------------------------- host pieces
RING_GRAPHS = {"er90": ("erdos_renyi", (90, 5.0), {"seed": 4}),
               "grid16": ("grid_2d", (16, 16), {}),
               "star300": ("star", (300,), {})}


def _graphs(name):
    fn, args, kw = RING_GRAPHS[name]
    return getattr(generators, fn)(*args, **kw), getattr(ref_gen, fn)(
        *args, **kw)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("gname", sorted(RING_GRAPHS))
def test_build_ring_edges_equals_reference(gname, shards):
    g, ref_g = _graphs(gname)
    np.testing.assert_array_equal(g.indices, ref_g.indices)
    got = tdist.build_ring_edges(g, shards)
    want = ref_dist.build_ring_edges(ref_g, shards)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


COLORING_CASES = [(0, 128, 90, 5), (5 * 1_000_003 + 3, 1024, 600, 7),
                  (2 ** 31 - 1, 256, 256, 12), (2 ** 32 - 1, 384, 300, 3),
                  (-(2 ** 31), 128, 17, 10), (-1_000_003, 512, 500, 4)]


@pytest.mark.parametrize("seed,n_pad,n_true,k", COLORING_CASES)
def test_coloring_for_seed_equals_reference(seed, n_pad, n_true, k):
    got = tdist.coloring_for_seed(seed, n_pad, n_true, k, device="cpu")
    # the reference's stream ids are int32 arrays inside its jit; a
    # Python int goes through as uint32
    ref_seed = jax.numpy.int32(seed) if seed < 0 else seed
    want = np.asarray(ref_dist.coloring_for_seed(ref_seed, n_pad, n_true, k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[n_true:] == k + 1).all()


def test_stream_ids_overflow_as_the_reference_does():
    with pytest.raises(OverflowError):
        jax.numpy.asarray([3000 * 1_000_003], jax.numpy.int32)
    with pytest.raises(OverflowError):
        tdist._stream_id(3000, 0)
    assert tdist._stream_id(2147, 0) == 2147 * 1_000_003
    for bad in (2 ** 32, -(2 ** 31) - 1):
        with pytest.raises(OverflowError):
            tdist.coloring_for_seed(bad, 128, 10, 3, device="cpu")


def _ref_layout(template, d_data, d_model, plan):
    """The reference's DistributedPgbsc on a stand-in mesh: its
    constructor reads only the mesh's axis names and shape."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": d_data, "model": d_model})
    return ref_dist.DistributedPgbsc(ref_gen.erdos_renyi(90, 5.0, seed=4),
                                     ref_get_template(template), mesh,
                                     plan=plan)


@pytest.mark.parametrize("d_model", [1, 2, 4])
@pytest.mark.parametrize("tname", ["u5", "u7", "u10", "u12", "path5",
                                   "star5"])
def test_shard_plan_equals_reference(tname, d_model):
    t = get_template(tname)
    for plan in PLANS:
        plan_obj = {"plain": t.plan, "dedup": t.plan_dedup,
                    "optimized": t.plan_optimized}[plan]
        got = tdist.shard_plan(plan_obj, t.k, d_model)
        ref = _ref_layout(tname, 2, d_model, plan)
        assert len(got) == len(ref.meta)
        for i, (m, r) in enumerate(zip(got, ref.meta)):
            assert (m.width, m.width_pad, m.active, m.passive) == (
                r.width, r.width_pad, r.active, r.passive)
            if r.ia is None:
                assert m.ia is None and m.collective is None
                continue
            np.testing.assert_array_equal(m.ia, r.ia)
            np.testing.assert_array_equal(m.ip, r.ip)
            # the reference's rule, read off its padded widths
            a_pad = ref.meta[r.active].width_pad
            p_pad = ref.meta[r.passive].width_pad
            want = ("scatter" if p_pad + 2 * r.width_pad < a_pad + p_pad
                    else "gather")
            assert m.collective == want, (plan, i)


@pytest.mark.parametrize("n_ids,n_pods", [(1, 1), (5, 1), (1, 2), (5, 2),
                                          (8, 2), (17, 8), (16, 8),
                                          (3, 4)])
def test_pod_rounds_pad_only_the_last_round(n_ids, n_pods):
    ids = [10 + 3 * i for i in range(n_ids)]
    rounds = tdist.pod_rounds(ids, n_pods)
    assert len(rounds) == -(-n_ids // n_pods)
    assert all(len(r) == n_pods for r in rounds)
    flat = [i for r in rounds for i in r]
    assert flat[:n_ids] == ids
    assert flat[n_ids:] == [ids[-1]] * (len(flat) - n_ids)
    assert tdist.pod_rounds([], n_pods) == []


@pytest.mark.parametrize("d_model", [1, 2, 4])
@pytest.mark.parametrize("tname", ["u7", "u10", "path5"])
def test_scatter_remap_equals_masked_sum(tname, d_model):
    """Each model shard's eMA over its active rows and the passive child
    with one zero row after it, with the remapped split tables, equals the
    reference's masked sum; the shards' partials add up to the whole eMA's
    rows."""
    t = get_template(tname)
    meta = tdist.shard_plan(t.plan_dedup, t.k, d_model)
    rng = np.random.default_rng(d_model)
    n = 37
    for idx, m in enumerate(meta):
        if m.collective is None:
            continue
        m.collective = "scatter"        # every node, whatever its rule
        a_pad = meta[m.active].width_pad
        p_pad = meta[m.passive].width_pad
        m_a = rng.integers(0, 5, (a_pad, n)).astype(np.float32)
        y_p = rng.integers(0, 5, (p_pad, n)).astype(np.float32)
        a_rows = a_pad // d_model
        y_p_zero = np.vstack([y_p, np.zeros((1, n), np.float32)])
        total = np.zeros((m.width_pad, n), np.float32)
        for my in range(d_model):
            m_a_loc = m_a[my * a_rows:(my + 1) * a_rows]
            ia, ip = tdist.local_splits(meta, idx, d_model, my)
            assert ia.max() < a_rows and ip.max() <= p_pad
            got = ema_ops.ema_plain(
                torch.as_tensor(m_a_loc), torch.as_tensor(y_p_zero),
                torch.as_tensor(ia), torch.as_tensor(ip)).numpy()
            lo = my * a_rows
            want = np.zeros((m.width_pad, n), np.float32)
            for l in range(m.ia.shape[1]):
                ga = m.ia[:, l]
                own = (ga >= lo) & (ga < lo + a_rows)
                term = (m_a_loc[np.clip(ga - lo, 0, a_rows - 1)]
                        * y_p[m.ip[:, l]])
                want += np.where(own[:, None], term, 0.0)
            np.testing.assert_array_equal(got, want)
            total += got
        full = (m_a[m.ia] * y_p[m.ip]).sum(axis=1)
        np.testing.assert_array_equal(total, full)


def _directed(case):
    rng = np.random.default_rng(7)
    if case == "empty":
        return 128, np.zeros(0, np.int32), np.zeros(0, np.int32)
    if case == "hub":                    # a destination over HUB_DEGREE
        n = 300
        src = rng.integers(0, n, 3 * spmm_ops.HUB_DEGREE + 5)
        dst = np.r_[np.full(3 * spmm_ops.HUB_DEGREE, 17), rng.integers(
            0, n, 5)]
        order = np.argsort(dst, kind="stable")
        return n, src[order], dst[order]
    n = 256                               # repeated edges, sources unsorted
    return n, rng.integers(0, n, 2000), np.sort(rng.integers(0, n, 2000))


@pytest.mark.parametrize("case", ["random", "hub", "empty"])
def test_directed_gather_operand_equals_dense_product(case):
    n, src, dst = _directed(case)
    prep = spmm_ops.gather_prep_from_edges(n, src, dst, device="cpu")
    assert prep.n == n and int(prep.row_ptr[-1]) == len(src)
    if case == "hub":
        assert prep.n_hubs == 1 and prep.n_segments == 3
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (src, dst), 1.0)
    m = np.random.default_rng(1).integers(0, 4, (3, 5, n)).astype(np.float32)
    got = spmm_ops.spmm_gather_plain(torch.as_tensor(m), prep).numpy()
    np.testing.assert_array_equal(got, (m.astype(np.float64) @ a)
                                  .astype(np.float32))


def test_directed_gather_operand_rejects_unsorted_destinations():
    n, src, dst = _directed("random")
    with pytest.raises(ValueError, match="sorted by destination"):
        spmm_ops.gather_prep_from_edges(n, src, dst[::-1], device="cpu")


def test_make_mesh_needs_a_process_group_and_known_axes():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="axes"):
        make_mesh((2, 2), ("model", "data"), device="cpu")


def test_distributed_pgbsc_device_rule_and_abstract_mode(monkeypatch):
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 device_type="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.DistributedPgbsc(generators.grid_2d(4, 4), "u3", mesh)
    # the abstract mode needs its shapes, and outside a fake mode (and a
    # fake process group) the device rule holds for it too
    with pytest.raises(ValueError, match="abstract_dims"):
        tdist.DistributedPgbsc(None, "u3", mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.DistributedPgbsc(None, "u3", mesh,
                               abstract_dims={"n": 64, "e": 256})


# ------------------------------------------------------- the rank runs
_RANK = r'''
import json, os, shutil, sys, warnings
warnings.filterwarnings("ignore", category=FutureWarning)
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.core import get_template
from repro_torch.core.distributed import DistributedPgbsc
from repro_torch.core.runner import EstimatorRunner, distributed_counter
from repro_torch.graph import generators
from repro_torch.launch.mesh import make_mesh

MESHES, TEMPLATES, PLANS, ITERS, SEED, (fn, args, kw) = json.loads(
    sys.argv[5])
g = getattr(generators, fn)(*args, **kw)
meshes = {name: make_mesh(shape, axes, device="cpu")
          for name, (shape, axes) in MESHES.items()}
res = {"sums": {}}
for name, mesh in meshes.items():
    for t in TEMPLATES:
        for plan in PLANS:
            d = DistributedPgbsc(g, t, mesh, plan=plan)
            _, per = d.count_iterations(list(ITERS), seed=SEED)
            res["sums"][f"{name}/{t}/{plan}"] = per

# one coloring per pod, and the stream-id overflow, raised on every rank
# before any collective
d3 = DistributedPgbsc(g, "u5", meshes["2x2x2"])
res["step"] = d3.count_step([SEED * 1_000_003 + 0, SEED * 1_000_003 + 1])
# five iterations on two pods: three plan walks a rank, the last round's
# second pod padded
walks = []
count_one = d3._count_one
d3._count_one = lambda colors: walks.append(1) or count_one(colors)
res["five_on_two_pods"] = [len(d3.count_iterations(range(5), seed=SEED)[1]),
                           len(walks)]
d3._count_one = count_one
try:
    d3.count_iterations([0], seed=3000)
    res["overflow"] = False
except OverflowError:
    res["overflow"] = True

# the runner on the reference's test graph: cut, resumed, straight, and
# finished on another mesh; each rank keeps its own ledgers
g90 = generators.erdos_renyi(90, 5.0, seed=4)
t = get_template("u5")
dist3 = DistributedPgbsc(g90, t, meshes["2x2x2"])
dist2 = DistributedPgbsc(g90, t, meshes["4x2"])
total, _ = dist3.count_iterations(list(range(64)), seed=3)
res["colorful_mean_64"] = total / 64
tmp = os.path.join(os.path.dirname(out), f"ledgers{rank}")
kw = dict(k=t.k, automorphisms=t.automorphisms, checkpoint_every=4, seed=3)
counter = distributed_counter(dist3, seed=3)
partial = EstimatorRunner(counter, n_iterations=12,
                          ledger_dir=tmp + "/a", **kw).run(
    max_iterations_this_call=5)
resumed = EstimatorRunner(counter, n_iterations=12, ledger_dir=tmp + "/a",
                          **kw).run()
straight = EstimatorRunner(counter, n_iterations=12, ledger_dir=tmp + "/b",
                           **kw).run()
elastic = EstimatorRunner(distributed_counter(dist2, seed=3),
                          n_iterations=16, ledger_dir=tmp + "/a", **kw).run()
res["runner"] = {
    "partial": len(partial.completed), "resumed": len(resumed.completed),
    "restarts": resumed.restarts, "resumed_per": resumed.per_iteration,
    "straight_per": straight.per_iteration, "resumed_count": resumed.count,
    "straight_count": straight.count, "elastic": len(elastic.completed),
    "elastic_per": elastic.per_iteration}
shutil.rmtree(tmp)
with open(out, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
'''

_JAX = r'''
import json, os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_threefry_partitionable", True)
from repro.core.distributed import DistributedPgbsc
from repro.graph import generators
from repro.launch.mesh import make_mesh
TEMPLATES, PLANS, ITERS, SEED, (fn, args, kw) = json.loads(sys.argv[1])
g = getattr(generators, fn)(*args, **kw)
mesh = make_mesh((4, 2), ("data", "model"))
out = {}
for t in TEMPLATES:
    for plan in PLANS:
        _, per = DistributedPgbsc(g, t, mesh, plan=plan).count_iterations(
            list(ITERS), seed=SEED)
        out[f"{t}/{plan}"] = per
print("SUMS " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    spec = json.dumps([MESHES, TEMPLATES, PLANS, ITERS, SEED, SUMS_GRAPH])
    cmds = {f"rank{r}": [sys.executable, "-c", _RANK, str(r), str(WORLD),
                         str(tmp / "store"), str(tmp / f"rank{r}.json"),
                         spec]
            for r in range(WORLD)}
    cmds["jax"] = [sys.executable, "-c", _JAX, json.dumps(
        [TEMPLATES, PLANS, ITERS, SEED, SUMS_GRAPH])]
    done = run_all(cmds, env, tmp, TIMEOUT_S)
    for name, (rc, _, err) in done.items():
        assert rc == 0, f"{name} exited {rc}:\n{err[-4000:]}"
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    line = next(s for s in done["jax"][1].splitlines()
                if s.startswith("SUMS "))
    return {"ranks": ranks, "jax": json.loads(line[5:])}


def _per(d):
    return {int(k): v for k, v in d.items()}


_ENGINE_SUMS: dict = {}


def _engine_sums(tname, plan):
    """The port's single-device gather engine on the same colorings."""
    if (tname, plan) not in _ENGINE_SUMS:
        fn, args, kw = SUMS_GRAPH
        g = getattr(generators, fn)(*args, **kw)
        t = get_template(tname)
        eng = CountingEngine(g, t, plan=plan, spmm_method="gather",
                             fuse_spmm_ema=False, device="cpu")
        sums = {}
        for it in ITERS:
            colors = tdist.coloring_for_seed(SEED * 1_000_003 + it, 1024,
                                             g.n, t.k, device="cpu")[:g.n]
            sums[it] = float(eng.count_colorful(colors)[0])
        _ENGINE_SUMS[tname, plan] = sums
    return _ENGINE_SUMS[tname, plan]


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("tname", TEMPLATES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_distributed_sums_equal_reference_and_engine(runs, mesh, tname,
                                                     plan):
    key = f"{mesh}/{tname}/{plan}"
    got = [_per(r["sums"][key]) for r in runs["ranks"]]
    assert all(g == got[0] for g in got[1:]), "ranks disagree"
    assert sorted(got[0]) == list(ITERS)
    assert got[0] == _per(runs["jax"][f"{tname}/{plan}"])
    assert got[0] == _engine_sums(tname, plan)
    # every mesh gives the same sums
    for other in MESHES:
        assert _per(runs["ranks"][0]["sums"][f"{other}/{tname}/{plan}"]) \
            == got[0], other
    assert min(got[0].values()) > 0


def test_count_step_runs_one_coloring_per_pod(runs):
    per = _per(runs["ranks"][0]["sums"]["2x2x2/u5/dedup"])
    for r in runs["ranks"]:
        assert r["step"] == [per[0], per[1]]
        assert r["overflow"] is True
        assert r["five_on_two_pods"] == [5, 3]


def test_resumed_run_equals_straight_run(runs):
    for r in runs["ranks"]:
        run = r["runner"]
        assert run["partial"] >= 5 and run["resumed"] == 12
        assert run["restarts"] >= 1
        assert run["resumed_per"] == run["straight_per"]
        assert run["resumed_count"] == run["straight_count"]
    assert all(r["runner"] == runs["ranks"][0]["runner"]
               for r in runs["ranks"])


def test_elastic_finish_on_another_mesh(runs):
    run = runs["ranks"][0]["runner"]
    assert run["elastic"] == 16
    # the 12 iterations done on the pod mesh are kept, the rest are new
    assert {k: v for k, v in run["elastic_per"].items()
            if int(k) < 12} == run["straight_per"]


def test_estimate_within_reference_bound_of_exact(runs):
    g = generators.erdos_renyi(90, 5.0, seed=4)
    t = get_template("u5")
    exact = count_subgraphs_exact(g, t)
    est = runs["ranks"][0]["colorful_mean_64"] / (
        t.automorphisms * colorful_probability(t.k))
    assert abs(est - exact) / exact < 0.35, (est, exact)
