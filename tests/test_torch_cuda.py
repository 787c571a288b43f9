"""The CUDA kernels on the card, at small shapes and their edge cases.

Run on a machine with a CUDA card (and ``nvcc``):
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``. Without a
card every test skips (the ``card`` fixture decides, at run time). Each
kernel is held against its plain PyTorch version on the same device: f32
exactly (integer-valued tables), bf16 within ``1e-2`` relative; the wrappers
must raise on what the kernels do not take, and count only real launches.
"""

import importlib.util
from math import comb
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.colorsets import split_tables
from repro_torch.core.engines import CountingEngine
from repro_torch.graph.coloring import batch_colorings
from repro_torch.core.templates import TemplateSpec
from repro_torch.graph.generators import (complete_graph, erdos_renyi,
                                          grid_2d, rmat, star)
from repro_torch.graph.structure import Graph
from repro_torch.kernels.ema import ops as ema_ops
from repro_torch.kernels.fused import ops as fused_ops
from repro_torch.kernels.spmm import ops as spmm_ops

GRAPHS = {
    "ragged": lambda: erdos_renyi(300, 7.0, seed=1),     # n % 128 != 0
    "small": lambda: grid_2d(5, 7),                       # n < one tile
    "grid": lambda: grid_2d(40, 33),
    "empty": lambda: Graph.from_edges(200, np.zeros((0, 2), np.int64)),
}
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}


def census(k):
    """Every free tree on k vertices, from chip_smoke.py's enumerator."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [TemplateSpec(edges=e, root=r) for e, r in mod.census_trees(k)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 machine)")
    return torch.device("cuda")


def _rand(shape, dtype, device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 4, shape, generator=g, device=device).to(dtype)


def _splits(k, t, ta, device):
    return [torch.as_tensor(a, dtype=torch.int32, device=device)
            for a in split_tables(k, t, ta)]


def _close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape
    if got.numel():
        rel = (got - want).abs() / want.abs().clamp_min(1.0)
        assert rel.max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("b", [1, 3])
def test_spmm_kernel_matches_plain(card, dtype, gname, b):
    g = GRAPHS[gname]()
    prep = spmm_ops.prepare(g, dtype=dtype, device=card)
    m = _rand((b, 70, g.n), dtype, card, b)          # rows not a multiple
    before = spmm_ops.spmm.launches                  # of the 64-row block
    got = spmm_ops.spmm(m, prep)
    assert spmm_ops.spmm.launches == before + 1
    _close(got, spmm_ops.spmm_plain(m, prep), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,t,ta", [(5, 3, 1), (7, 4, 2), (12, 7, 6),
                                    (12, 12, 1), (7, 7, 3)])
@pytest.mark.parametrize("b", [1, 3])
def test_ema_kernel_matches_plain(card, dtype, k, t, ta, b):
    n = 1000
    ia, ip = _splits(k, t, ta, card)
    m_a = _rand((b, comb(k, ta), n), dtype, card, k)
    y_p = _rand((b, comb(k, t - ta), n), dtype, card, t)
    got = ema_ops.ema(m_a, y_p, ia, ip)
    _close(got, ema_ops.ema_plain(m_a, y_p, ia, ip), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("k,t,ta", [(5, 3, 1), (12, 6, 1), (12, 4, 1)])
@pytest.mark.parametrize("b", [1, 3])
def test_fused_kernel_matches_plain(card, dtype, gname, k, t, ta, b):
    g = GRAPHS[gname]()
    prep = spmm_ops.prepare(g, dtype=dtype, device=card)
    ia, ip = _splits(k, t, ta, card)
    m_a = _rand((b, comb(k, ta), g.n), dtype, card, b)
    m_p = _rand((b, comb(k, t - ta), g.n), dtype, card, b + 1)
    got = fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, prep)
    _close(got, fused_ops.fused_spmm_ema_plain(m_a, m_p, ia, ip, prep),
           dtype)


def test_unbatched_fused_and_ema(card):
    g = GRAPHS["ragged"]()
    prep = spmm_ops.prepare(g, device=card)
    ia, ip = _splits(7, 4, 2, card)
    m_a = _rand((21, g.n), torch.float32, card, 0)
    m_p = _rand((21, g.n), torch.float32, card, 1)
    got = fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, prep)
    assert got.shape == (35, g.n)
    _close(got, ema_ops.ema(m_a, spmm_ops.spmm(m_p, prep), ia, ip),
           torch.float32)


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    g = GRAPHS["ragged"]()
    prep = spmm_ops.prepare(g, device=card)
    ia, ip = _splits(5, 3, 1, card)
    m = _rand((2, 5, g.n), torch.float32, card, 0)
    with pytest.raises(TypeError):                         # f16 storage
        spmm_ops.spmm(m.half(), spmm_ops.prepare(g, dtype=torch.float16,
                                                 device=card))
    with pytest.raises(TypeError):                         # dtype mismatch
        spmm_ops.spmm(m.bfloat16(), prep)
    with pytest.raises(ValueError):                        # not contiguous
        spmm_ops.spmm(m.transpose(0, 1), prep)
    with pytest.raises(ValueError):                        # wrong device
        spmm_ops.spmm(m, spmm_ops.prepare(g, device="cpu"))
    with pytest.raises(TypeError):                         # int64 splits
        ema_ops.ema(m, m.repeat(1, 2, 1), ia.long(), ip.long())
    wide = torch.zeros((1, 1600, g.n), device=card)        # c_p over limit
    with pytest.raises(ValueError, match="shared memory"):
        fused_ops.fused_spmm_ema(m[:1], wide, ia, ip, prep)


@pytest.mark.parametrize("tname", ["u5", "u7", "u12"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_on_card_matches_cpu(card, tname, dtype):
    g = grid_2d(30, 30)
    k = int(tname[1:])
    cols = batch_colorings(3, range(5), g.n, k, device="cpu")
    on_card = CountingEngine(g, tname, plan="optimized", device=card,
                             dtype=dtype)
    on_cpu = CountingEngine(g, tname, plan="optimized", device="cpu",
                            dtype=dtype)
    t_card, r_card = on_card.count_colorful_batch(cols)
    t_cpu, r_cpu = on_cpu.count_colorful_batch(cols)
    _close(t_card, t_cpu, dtype)
    _close(r_card, r_cpu, dtype)
    assert on_card.estimate(4, seed=1)["samples"] \
        == on_cpu.estimate(4, seed=1)["samples"]


def _group(k, cons, b, n, dtype, device, seed):
    """Consumers ``cons`` = [(t, t_a), ...] of one passive child with
    ``C(k, t - t_a)`` color sets on ``n`` vertices, as (m_as, m_p, ias,
    ips)."""
    t_p = cons[0][0] - cons[0][1]
    m_p = _rand((b, comb(k, t_p), n), dtype, device, seed)
    m_as, ias, ips = [], [], []
    for i, (t, ta) in enumerate(cons):
        ia, ip = _splits(k, t, ta, device)
        ias.append(ia)
        ips.append(ip)
        m_as.append(_rand((b, comb(k, ta), n), dtype, device, seed + i + 1))
    return m_as, m_p, ias, ips


# (k, consumers): the reference suite's two-consumer group (different
# c_a, S, L per consumer); census roots (S = 1, L = 252, split across the
# warps); a ragged S = 3 root pair; four consumers of S >= 8 rows
GROUPS = {
    "two_consumer": (5, [(5, 3), (4, 2)]),
    "census_roots": (10, [(10, 5)] * 3),
    "ragged_s": (6, [(5, 4), (5, 4)]),
    "wide_s": (12, [(7, 6), (7, 6), (7, 6), (7, 6)]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("b", [1, 3])
def test_shared_group_kernel_matches_plain(card, dtype, gname, group, b):
    g = GRAPHS[gname]()
    prep = spmm_ops.prepare(g, dtype=dtype, device=card)
    k, cons = GROUPS[group]
    m_as, m_p, ias, ips = _group(k, cons, b, g.n, dtype, card, b)
    before = fused_ops.fused_spmm_ema_shared.launches
    got = fused_ops.fused_spmm_ema_shared(m_as, m_p, ias, ips, prep)
    assert fused_ops.fused_spmm_ema_shared.launches == before + 1
    want = fused_ops.fused_spmm_ema_shared_plain(m_as, m_p, ias, ips, prep)
    assert len(got) == len(cons)
    for gt, wt in zip(got, want):
        _close(gt, wt, dtype)


def test_shared_group_wrapper_raises(card):
    g = GRAPHS["ragged"]()
    prep = spmm_ops.prepare(g, device=card)
    m_as, m_p, ias, ips = _group(5, [(5, 3)] * 17, 1, g.n, torch.float32,
                                 card, 0)
    with pytest.raises(ValueError, match="at most 16"):
        fused_ops.fused_spmm_ema_shared(m_as, m_p, ias, ips, prep)
    with pytest.raises(TypeError):                          # mixed dtypes
        fused_ops.fused_spmm_ema_shared(
            [m_as[0].bfloat16()], m_p, ias[:1], ips[:1], prep)
    with pytest.raises(ValueError, match="int32"):
        fused_ops.fused_spmm_ema_shared(
            m_as[:1], m_p, [ias[0].long()], [ips[0].long()], prep)
    wide = torch.zeros((1, 1600, g.n), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        fused_ops.fused_spmm_ema_shared(m_as[:1], wide, ias[:1], ips[:1],
                                        prep)


GATHER_GRAPHS = dict(GRAPHS, rmat=lambda: rmat(10, 8, seed=3),
                     hub=lambda: star(3000))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gname", sorted(GATHER_GRAPHS))
@pytest.mark.parametrize("rows", [1, 70])
@pytest.mark.parametrize("b", [1, 3])
def test_gather_kernel_matches_plain(card, dtype, gname, rows, b):
    g = GATHER_GRAPHS[gname]()
    prep = spmm_ops.prepare(g, "gather", device=card)
    m = _rand((b, rows, g.n), dtype, card, rows + b)
    before = (spmm_ops.spmm_gather.launches, spmm_ops.spmm.launches)
    got = spmm_ops.spmm(m, prep)
    assert (spmm_ops.spmm_gather.launches, spmm_ops.spmm.launches) \
        == (before[0] + 1, before[1])
    _close(got, spmm_ops.spmm_gather_plain(m, prep), dtype)
    bsr = spmm_ops.prepare(g, dtype=dtype, device=card)
    _close(got, spmm_ops.spmm(m, bsr), dtype)


def test_gather_wrapper_raises(card):
    g = GRAPHS["ragged"]()
    prep = spmm_ops.prepare(g, "gather", device=card)
    m = _rand((2, 5, g.n), torch.float32, card, 0)
    with pytest.raises(TypeError):                         # f16 storage
        spmm_ops.spmm(m.half(), prep)
    with pytest.raises(ValueError):                        # not contiguous
        spmm_ops.spmm(m.transpose(0, 1), prep)
    with pytest.raises(ValueError):                        # wrong device
        spmm_ops.spmm(m, spmm_ops.prepare(g, "gather", device="cpu"))


SPMM_CASES = {
    "complete200": lambda: complete_graph(200),      # dense blocks
    "star": lambda: star(3000),                      # a hub of 24 segments
    "rmat_hubs": lambda: rmat(10, 16, seed=3),       # 28 hubs, 65 segments
    "small": GRAPHS["small"],                        # n < 128
    "ragged": GRAPHS["ragged"],                      # n % 128 != 0
    "empty": GRAPHS["empty"],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gname", sorted(SPMM_CASES))
@pytest.mark.parametrize("rows", [1, 70, 220])      # not multiples of a
@pytest.mark.parametrize("method", ["bsr", "gather"])  # kernel's row chunk
def test_spmm_kernels_match_plain_deterministically(card, dtype, gname, rows,
                                                    method):
    g = SPMM_CASES[gname]()
    prep = spmm_ops.prepare(g, method, dtype=dtype, device=card)
    if gname in ("star", "rmat_hubs") and method == "gather":
        assert prep.n_segments >= 3
    counter, plain = ((spmm_ops.spmm, spmm_ops.spmm_plain) if method == "bsr"
                      else (spmm_ops.spmm_gather, spmm_ops.spmm_gather_plain))
    m = _rand((rows, g.n), dtype, card, rows)
    before = counter.launches
    got = spmm_ops.spmm(m, prep)
    assert counter.launches == before + 1
    again = spmm_ops.spmm(m, prep)
    assert counter.launches == before + 2
    assert torch.equal(got, again)                   # bit for bit
    _close(got, plain(m, prep), dtype)


def _rand_splits(s, l, c_a, c_p, device, seed):
    """Random (S, L) int32 split tables into c_a and c_p rows."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.integers(0, c, size=(s, l)), dtype=torch.int32,
                            device=device) for c in (c_a, c_p)]


# fused kernel edge cases: (graph, c_a, c_p, S, L). On the 64 x 64 mesh a
# tile's +-1 neighbour blocks touch only half its 32-column slices, so the
# others find no nonzero in them; n = 301 (not a multiple of 4 or 8) copies
# the m_a slice element by element and stores outputs one by one; c_p = 70
# and 37 are no multiple of the 16 x 8 rows of a pass; c_p = 1,560 fills
# the fit limit; c_a = 300 in f32 is over the m_a slice's 32 KB.
FUSED_CASES = {
    "skipped_blocks": (lambda: grid_2d(64, 64), 12, 66, 220, 3),
    "n_not_vec": (lambda: erdos_renyi(301, 7.0, seed=4), 12, 70, 40, 5),
    "c_p_ragged": (lambda: grid_2d(40, 33), 9, 37, 17, 4),
    "c_p_fit_limit": (lambda: erdos_renyi(300, 7.0, seed=5), 6, 1560, 3, 6),
    "wide_m_a": (lambda: grid_2d(40, 33), 300, 45, 260, 7),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_kernel_edge_cases_deterministically(card, dtype, case):
    build, c_a, c_p, s, l = FUSED_CASES[case]
    g = build()
    prep = spmm_ops.prepare(g, dtype=dtype, device=card)
    if case == "skipped_blocks":       # a slice without nonzeros in a block
        col_ptr = prep.col_ptr.cpu().numpy()
        assert (col_ptr[:, 0:128:32] == col_ptr[:, 32::32]).any()
    if case == "n_not_vec":
        assert g.n % 8 != 0 and g.n % 4 != 0
    ia, ip = _rand_splits(s, l, c_a, c_p, card, c_p)
    m_a = _rand((2, c_a, g.n), dtype, card, 1)
    m_p = _rand((2, c_p, g.n), dtype, card, 2)
    before = fused_ops.fused_spmm_ema.launches
    got = fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, prep)
    again = fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, prep)
    assert fused_ops.fused_spmm_ema.launches == before + 2
    assert torch.equal(got, again)                   # bit for bit
    _close(got, fused_ops.fused_spmm_ema_plain(m_a, m_p, ia, ip, prep), dtype)


# group kernel edge cases: (graph, c_p, [(c_a, S, L) per consumer]). The
# 64 x 64 mesh has slices without a nonzero in a block (as above); n = 301
# copies each m_a slice element by element and stores outputs one by one;
# c_p = 37 is no multiple of a pass of the leg; c_p = 1,552 fills the group
# fit limit; c_a = 300 in f32 is over the 32 KB m_a slice (read directly,
# then a staged consumer after it); S = 1 with L = 35 splits its terms
# unevenly over 16 half-warps, L = 252 and S = 2 with L = 150 take several
# staged chunks of the split table; S = 3 leaves a row of half-warps idle;
# "mixed_s" puts an S = 1 and an S >= 16 consumer in one group;
# "many_staged" stages five or six m_a slices one after another, its
# c_a = 300 consumer read directly between them in f32, staged in bf16.
GROUP_CASES = {
    "skipped_blocks": (lambda: grid_2d(64, 64), 66,
                       [(45, 1, 66), (12, 3, 10)]),
    "n_not_vec": (lambda: erdos_renyi(301, 7.0, seed=4), 70,
                  [(12, 1, 40), (70, 5, 9)]),
    "c_p_ragged": (lambda: grid_2d(40, 33), 37, [(9, 2, 17), (9, 1, 37)]),
    "c_p_fit_limit": (lambda: erdos_renyi(300, 7.0, seed=5), 1552,
                      [(6, 1, 6), (10, 8, 12)]),
    "wide_m_a": (lambda: grid_2d(40, 33), 45,
                 [(300, 1, 45), (20, 4, 7), (300, 17, 3)]),
    "l_ragged": (lambda: grid_2d(40, 33), 35, [(35, 1, 35)] * 3),
    "long_l": (lambda: grid_2d(40, 33), 252,
               [(252, 1, 252), (252, 1, 252), (210, 2, 150)]),
    "mixed_s": (lambda: grid_2d(40, 33), 120, [(210, 1, 120), (45, 40, 6)]),
    "many_staged": (lambda: grid_2d(40, 33), 252,
                    [(252, 1, 252)] * 3 + [(300, 2, 9)] + [(252, 1, 252)] * 2),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_kernel_edge_cases_deterministically(card, dtype, case):
    build, c_p, cons = GROUP_CASES[case]
    g = build()
    prep = spmm_ops.prepare(g, dtype=dtype, device=card)
    if case == "skipped_blocks":       # a slice without nonzeros in a block
        col_ptr = prep.col_ptr.cpu().numpy()
        assert (col_ptr[:, 0:128:32] == col_ptr[:, 32::32]).any()
    if case == "n_not_vec":
        assert g.n % 8 != 0 and g.n % 2 != 0
    assert fused_ops.fused_group_fits_smem(len(cons), c_p, dtype)
    m_p = _rand((2, c_p, g.n), dtype, card, 2)
    m_as, ias, ips = [], [], []
    for i, (c_a, s, l) in enumerate(cons):
        ia, ip = _rand_splits(s, l, c_a, c_p, card, 10 * i + s)
        ias.append(ia)
        ips.append(ip)
        m_as.append(_rand((2, c_a, g.n), dtype, card, 3 + i))
    before = fused_ops.fused_spmm_ema_shared.launches
    got = fused_ops.fused_spmm_ema_shared(m_as, m_p, ias, ips, prep)
    again = fused_ops.fused_spmm_ema_shared(m_as, m_p, ias, ips, prep)
    assert fused_ops.fused_spmm_ema_shared.launches == before + 2
    want = fused_ops.fused_spmm_ema_shared_plain(m_as, m_p, ias, ips, prep)
    assert len(got) == len(again) == len(want) == len(cons)
    for gt, ag, wt, (_, s, _) in zip(got, again, want, cons):
        assert gt.shape == (2, s, g.n)
        assert torch.equal(gt, ag)                   # bit for bit
        _close(gt, wt, dtype)


# eMA edge cases: (c_a, c_p, S, L, n). The staged path holds c_a + c_p
# <= 1,816 rows in f32 and 3,632 in bf16: "over_smem" takes the direct path
# in both dtypes, "staged" the staged one; "census_root" (S = 1) and
# "few_rows" (S <= 8) the direct one; n = 1001 stages element by element.
EMA_CASES = {
    "staged": (924, 12, 100, 7, 1000),
    "staged_n_not_vec": (300, 45, 60, 9, 1001),
    "over_smem": (3600, 100, 20, 5, 1000),
    "census_root": (252, 252, 1, 252, 1000),
    "few_rows": (210, 10, 8, 6, 1001),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(EMA_CASES))
def test_ema_kernel_paths_deterministically(card, dtype, case):
    c_a, c_p, s, l, n = EMA_CASES[case]
    ia, ip = _rand_splits(s, l, c_a, c_p, card, s)
    m_a = _rand((3, c_a, n), dtype, card, 3)
    y_p = _rand((3, c_p, n), dtype, card, 4)
    before = ema_ops.ema.launches
    got = ema_ops.ema(m_a, y_p, ia, ip)
    again = ema_ops.ema(m_a, y_p, ia, ip)
    assert ema_ops.ema.launches == before + 2
    assert torch.equal(got, again)                   # bit for bit
    _close(got, ema_ops.ema_plain(m_a, y_p, ia, ip), dtype)
    if dtype == torch.float32:                       # terms ascending in l
        assert torch.equal(got, ema_ops.ema_plain(m_a, y_p, ia, ip))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bundle_engine_on_card_matches_cpu(card, dtype):
    g = grid_2d(30, 30)
    bundle = census(6)
    cols = batch_colorings(2, range(4), g.n, 6, device="cpu")
    on_card = CountingEngine(g, bundle, plan="dedup", device=card,
                             dtype=dtype)
    on_cpu = CountingEngine(g, bundle, plan="dedup", device="cpu",
                            dtype=dtype)
    assert on_card.schedule.fused_groups
    before = fused_ops.fused_spmm_ema_shared.launches
    t_card, r_card = on_card.count_colorful_batch(cols)
    assert fused_ops.fused_spmm_ema_shared.launches > before
    t_cpu, r_cpu = on_cpu.count_colorful_batch(cols)
    _close(t_card, t_cpu, dtype)
    for a, b in zip(r_card, r_cpu):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_engine_on_card_matches_cpu(card, dtype):
    g = rmat(10, 8, seed=1)
    kw = dict(plan="optimized", spmm_method="gather", fuse_spmm_ema=False,
              dtype=dtype)
    on_card = CountingEngine(g, "u7", device=card, **kw)
    on_cpu = CountingEngine(g, "u7", device="cpu", **kw)
    assert on_card._fused_prep is None
    cols = batch_colorings(3, range(5), g.n, 7, device="cpu")
    t_card, r_card = on_card.count_colorful_batch(cols)
    t_cpu, r_cpu = on_cpu.count_colorful_batch(cols)
    _close(t_card, t_cpu, dtype)
    _close(r_card, r_cpu, dtype)


# the chunk-accumulate kernel: (k, t, t_a, chunks, batch). "r1": single
# passive rows (u13 node 5's kind of chunking); "r_gt_1": 26 rows a chunk,
# so an output row takes several pairs in one chunk; "short_last": 19 rows
# a chunk over 56, the last one 18 rows; "batched": B = 3, whose chunks
# are strided slices copied by spmm_row_chunk. n = 1000 is not a multiple
# of the kernel's 256 columns.
CHUNK_CASES = {
    "r1": (10, 6, 1, 252, 1),
    "r_gt_1": (9, 6, 2, 5, 1),
    "short_last": (8, 5, 2, 3, 1),
    "batched": (9, 6, 2, 5, 3),
}


def _chunk_walk_inputs(k, t, t_a, q, b, dtype, device, seed):
    ia, ip = split_tables(k, t, t_a)
    c_a, c_p = comb(k, t_a), comb(k, t - t_a)
    pack = ema_ops.pack_chunked_splits(ia, ip, c_p, q)
    m_a = _rand((b, c_a, 1000), dtype, device, seed)
    m_p = _rand((b, c_p, 1000), dtype, device, seed + 1)
    return pack, m_a, m_p


def _accumulate(acc_fn, pack, walk, m_a, m_p):
    out = torch.zeros(m_a.shape[:-2] + (pack.n_out_rows, m_a.shape[-1]),
                      dtype=m_a.dtype, device=m_a.device)
    for q in range(pack.n_chunks):
        acc_fn(out, m_a, spmm_ops.spmm_row_chunk(m_p, q, pack.chunk_rows),
               walk, q)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_ema_chunk_kernel_matches_plain_deterministically(card, dtype, case):
    k, t, t_a, q, b = CHUNK_CASES[case]
    pack, m_a, m_p = _chunk_walk_inputs(k, t, t_a, q, b, dtype, card, q)
    walk = ema_ops.chunk_walk(pack, card)
    before = ema_ops.ema_chunk_acc.launches
    got = _accumulate(ema_ops.ema_chunk_acc, pack, walk, m_a, m_p)
    assert ema_ops.ema_chunk_acc.launches == before + q   # one a chunk
    again = _accumulate(ema_ops.ema_chunk_acc, pack, walk, m_a, m_p)
    assert torch.equal(got, again)                        # bit for bit
    want = _accumulate(ema_ops.ema_chunk_acc_plain, pack, walk, m_a, m_p)
    _close(got, want, dtype)
    # the CPU's plain version adds in the kernel's order: equal bit for bit
    cpu_walk = ema_ops.chunk_walk(pack, "cpu")
    on_cpu = _accumulate(ema_ops.ema_chunk_acc_plain, pack, cpu_walk,
                         m_a.cpu(), m_p.cpu())
    assert torch.equal(got.cpu(), on_cpu)
    if dtype == torch.float32:                   # the unchunked eMA
        ia, ip = _splits(k, t, t_a, card)
        _close(got, ema_ops.ema(m_a, m_p, ia, ip), dtype)


def test_ema_chunk_kernel_skips_a_chunk_without_pairs(card):
    pack, m_a, m_p = _chunk_walk_inputs(8, 5, 2, 3, 2, torch.float32, card,
                                        7)
    mask = pack.mask.copy()
    mask[1] = 0                                   # chunk 1: no real pairs
    empty = ema_ops.ChunkedSplits(
        out_idx=pack.out_idx, a_idx=pack.a_idx, p_loc=pack.p_loc, mask=mask,
        n_chunks=pack.n_chunks, chunk_rows=pack.chunk_rows,
        n_out_rows=pack.n_out_rows, pair_block=pack.pair_block)
    walk = ema_ops.chunk_walk(empty, card)
    out = _rand((2, pack.n_out_rows, 1000), torch.float32, card, 9)
    kept = out.clone()
    before = ema_ops.ema_chunk_acc.launches
    y = spmm_ops.spmm_row_chunk(m_p, 1, pack.chunk_rows)
    ema_ops.ema_chunk_acc(out, m_a, y, walk, 1)
    assert ema_ops.ema_chunk_acc.launches == before   # nothing launched
    assert torch.equal(out, kept)
    got = _accumulate(ema_ops.ema_chunk_acc, empty, walk, m_a, m_p)
    want = _accumulate(ema_ops.ema_chunk_acc_plain, empty, walk, m_a, m_p)
    assert ema_ops.ema_chunk_acc.launches == before + 2
    _close(got, want, torch.float32)


def test_ema_chunk_wrapper_raises(card):
    pack, m_a, m_p = _chunk_walk_inputs(8, 5, 2, 3, 2, torch.float32, card,
                                        1)
    walk = ema_ops.chunk_walk(pack, card)
    out = torch.zeros((2, pack.n_out_rows, 1000), device=card)
    y = spmm_ops.spmm_row_chunk(m_p, 0, pack.chunk_rows)
    with pytest.raises(TypeError):                         # dtype mismatch
        ema_ops.ema_chunk_acc(out, m_a.bfloat16(), y, walk, 0)
    with pytest.raises(TypeError):                         # f16 storage
        ema_ops.ema_chunk_acc(out.half(), m_a.half(), y.half(), walk, 0)
    with pytest.raises(ValueError):                        # not contiguous
        ema_ops.ema_chunk_acc(out, m_a, m_p[:, :pack.chunk_rows], walk, 0)
    with pytest.raises(ValueError):                        # wrong device
        ema_ops.ema_chunk_acc(out, m_a.cpu(), y, walk, 0)
    with pytest.raises(ValueError):                        # output rows
        ema_ops.ema_chunk_acc(out[:, :3].contiguous(), m_a, y, walk, 0)


@pytest.mark.parametrize("method", ["bsr", "gather"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_engine_on_card_matches_cpu(card, dtype, method):
    g = grid_2d(32, 32)
    kw = dict(plan="optimized", memory_budget_bytes=(16 << 20)
              // (4 // dtype.itemsize), dtype=dtype, spmm_method=method)
    on_card = CountingEngine(g, "u13", device=card, **kw)
    on_cpu = CountingEngine(g, "u13", device="cpu", **kw)
    assert on_card.schedule.chunk_map == {5: 1716}
    cols = batch_colorings(4, range(2), g.n, 13, device="cpu")
    # each chunk's neighbour sums go through the engine's SpMM kernel
    spmm_fn = spmm_ops.spmm if method == "bsr" else spmm_ops.spmm_gather
    before = (ema_ops.ema_chunk_acc.launches, spmm_fn.launches)
    t_card, r_card = on_card.count_colorful_batch(cols)
    assert ema_ops.ema_chunk_acc.launches == before[0] + 2 * 1716
    assert spmm_fn.launches >= before[1] + 2 * 1716
    t_cpu, r_cpu = on_cpu.count_colorful_batch(cols)
    _close(t_card, t_cpu, dtype)
    _close(r_card, r_cpu, dtype)


@pytest.mark.parametrize("method", ["bsr", "gather"])
@pytest.mark.parametrize("name", ["rcm", "degree"])
def test_reordered_engine_on_card_matches_cpu(card, name, method):
    perm = np.random.default_rng(3).permutation(40 * 40)
    from repro_torch.graph.reorder import apply_order
    g = apply_order(grid_2d(40, 40), perm)
    kw = dict(plan="optimized", reorder=name, spmm_method=method)
    on_card = CountingEngine(g, "u7", device=card, **kw)
    on_cpu = CountingEngine(g, "u7", device="cpu", **kw)
    cols = batch_colorings(5, range(3), g.n, 7, device="cpu")
    t_card, r_card = on_card.count_colorful_batch(cols)
    t_cpu, r_cpu = on_cpu.count_colorful_batch(cols)
    _close(t_card, t_cpu, torch.float32)
    _close(r_card, r_cpu, torch.float32)


# --------------------------------------------- the autotuner's launch shapes
TUNE_GRAPHS = {
    "odd": lambda: erdos_renyi(301, 5.0, seed=2),     # odd n
    "hub": lambda: star(3001),                         # hub segments, odd n
    "small": GRAPHS["small"],                          # n < one tile
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gname", sorted(TUNE_GRAPHS))
@pytest.mark.parametrize("rows", [1, 31, 33])
@pytest.mark.parametrize("method", ["bsr", "gather"])
def test_every_spmm_launch_shape_matches_plain(card, method, rows, gname,
                                              dtype):
    from repro_torch.kernels import autotune
    g = TUNE_GRAPHS[gname]()
    prep = spmm_ops.prepare(g, method, dtype=dtype, device=card)
    m = _rand((rows, g.n), dtype, card, rows)
    if method == "bsr":
        counter, plain, shapes = (spmm_ops.spmm, spmm_ops.spmm_plain,
                                  spmm_ops.BSR_ROWS)
    else:
        counter, plain, shapes = (spmm_ops.spmm_gather,
                                  spmm_ops.spmm_gather_plain,
                                  spmm_ops.GATHER_DESTS)
    want = plain(m, prep)
    default = spmm_ops.spmm(m, prep)
    for c in shapes:
        got = spmm_ops.spmm(m, prep, c_block=c)
        assert torch.equal(got, default), c      # the order of every sum
        _close(got, want, dtype)
    # a tuned call: one real launch, its sweep counted apart
    autotune.clear_cache()
    before = (counter.launches, counter.sweep_launches)
    tuned = spmm_ops.spmm(m, prep, autotune=True)
    assert counter.launches == before[0] + 1
    assert counter.sweep_launches > before[1]
    assert torch.equal(tuned, default)
    again = (counter.launches, counter.sweep_launches)
    spmm_ops.spmm(m, prep, autotune=True)        # a cache hit: no sweep
    assert (counter.launches, counter.sweep_launches) == (again[0] + 1,
                                                          again[1])
    with pytest.raises(ValueError):
        spmm_ops.spmm(m, prep, c_block=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 33])
def test_bsr_spmm_sums_real_values_in_the_plain_order(card, rows, dtype):
    """Real-valued tables, whose sums change with their order, on a star
    whose hub tile's run is longer than one RUN_SEG segment: every launch
    shape equals the plain version bit for bit, so the kernel's segment
    length (rt::RUN_SEG) and the plain version's (spmm_ops.RUN_SEG) agree.
    The plain version runs on the CPU, where index_add_ adds in index
    order."""
    g = star(3001)
    prep = spmm_ops.prepare(g, dtype=dtype, device=card)
    prep_cpu = spmm_ops.prepare(g, dtype=dtype, device="cpu")
    assert int(prep_cpu.tile_ptr.diff().max()) > spmm_ops.RUN_SEG
    gen = torch.Generator().manual_seed(rows)
    m = torch.randn((rows, g.n), generator=gen).to(dtype)
    want = spmm_ops.spmm_plain(m, prep_cpu)
    for c in spmm_ops.bsr_shapes(rows):
        got = spmm_ops.spmm(m.to(card), prep, c_block=c).cpu()
        assert torch.equal(got, want), c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,t,ta", [(5, 3, 1), (12, 7, 6), (4, 3, 1),
                                    (10, 10, 5)])
@pytest.mark.parametrize("b", [1, 3])
def test_every_ema_launch_shape_matches_plain(card, dtype, k, t, ta, b):
    from repro_torch.kernels import autotune
    n = 301                                       # odd: a ragged slice
    ia, ip = _splits(k, t, ta, card)
    m_a = _rand((b, comb(k, ta), n), dtype, card, 1)
    y_p = _rand((b, comb(k, t - ta), n), dtype, card, 2)
    want = ema_ops.ema_plain(m_a, y_p, ia, ip)
    default = ema_ops.ema(m_a, y_p, ia, ip)
    shapes = ema_ops.ema_shapes(m_a, y_p, ia)
    assert len(shapes) >= 2
    for s_block, n_block in shapes:
        got = ema_ops.ema(m_a, y_p, ia, ip, s_block=s_block, n_block=n_block)
        assert torch.equal(got, default), (s_block, n_block)
        _close(got, want, dtype)
    other = [c for c in autotune.EMA_BLOCK_CANDIDATES if c not in shapes]
    with pytest.raises(ValueError, match="path cannot launch"):
        ema_ops.ema(m_a, y_p, ia, ip, s_block=other[0][0],
                    n_block=other[0][1])
    autotune.clear_cache()
    before = (ema_ops.ema.launches, ema_ops.ema.sweep_launches)
    tuned = ema_ops.ema(m_a, y_p, ia, ip, autotune=True)
    assert ema_ops.ema.launches == before[0] + 1
    assert ema_ops.ema.sweep_launches == before[1] + 4 * len(shapes)
    assert torch.equal(tuned, default)


@pytest.mark.parametrize("method", ["bsr", "gather"])
def test_autotuned_engine_on_card_matches_untuned(card, method):
    from repro_torch.kernels import autotune
    autotune.clear_cache()
    g = grid_2d(40, 33)
    cols = batch_colorings(2, range(3), g.n, 7, device="cpu")
    kw = dict(plan="optimized", spmm_method=method, device=card)
    t_plain, r_plain = CountingEngine(g, "u7", **kw).count_colorful_batch(
        cols)
    t_tuned, r_tuned = CountingEngine(
        g, "u7", autotune_blocks=True, **kw).count_colorful_batch(cols)
    assert torch.equal(t_plain, t_tuned) and torch.equal(r_plain, r_tuned)
    assert autotune.cache_info()


# ------------------------------------------ distributed counting's pieces
def _directed_piece(case, n=300):
    """One ring piece's directed edges, sorted by destination: a
    destination whose run outlasts HUB_DEGREE, or no edges at all."""
    rng = np.random.default_rng(5)
    if case == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    hub = 3 * spmm_ops.HUB_DEGREE + 7
    src = rng.integers(0, n, hub + 900)
    dst = np.r_[np.full(hub, 41), rng.integers(0, n, 900)]
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["hub", "empty"])
def test_gather_kernel_on_a_directed_piece_matches_plain(card, dtype, case):
    src, dst = _directed_piece(case)
    prep = spmm_ops.gather_prep_from_edges(300, src, dst, device=card)
    if case == "hub":
        assert prep.n_hubs == 1 and prep.n_segments == 4
    m = _rand((70, 300), dtype, card, 3)
    before = spmm_ops.spmm_gather.launches
    got = spmm_ops.spmm_gather(m, prep)
    assert spmm_ops.spmm_gather.launches == before + 1
    _close(got, spmm_ops.spmm_gather_plain(m, prep), dtype)


@pytest.mark.parametrize("d_model", [1, 2, 4])
@pytest.mark.parametrize("tname", ["u10", "u12"])
def test_scatter_remapped_ema_matches_plain(card, tname, d_model):
    from repro_torch.core import distributed as tdist
    from repro_torch.core.templates import get_template
    t = get_template(tname)
    meta = tdist.shard_plan(t.plan_dedup, t.k, d_model)
    n = 2000
    for idx, m in enumerate(meta):
        if m.collective != "scatter":
            continue
        a_rows = meta[m.active].width_pad // d_model
        # the gathered passive and its zero row
        y_p = torch.cat([_rand((meta[m.passive].width_pad, n), torch.float32,
                               card, idx), torch.zeros((1, n), device=card)])
        for my in range(d_model):
            ia, ip = (torch.as_tensor(a, device=card) for a in
                      tdist.local_splits(meta, idx, d_model, my))
            m_a = _rand((a_rows, n), torch.float32, card, my)
            got = ema_ops.ema(m_a, y_p, ia, ip)
            _close(got, ema_ops.ema_plain(m_a, y_p, ia, ip), torch.float32)


def test_distributed_world_one_on_card_matches_gather_engine(card, tmp_path):
    import torch.distributed as dist

    from repro_torch.core.distributed import (DistributedPgbsc,
                                              coloring_for_seed)
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        g = GRAPHS["grid"]()
        d = DistributedPgbsc(g, "u7", make_mesh((1, 1), ("data", "model")),
                             plan="dedup")
        _, per = d.count_iterations([0, 1, 2], seed=4)
        eng = CountingEngine(g, "u7", plan="dedup", spmm_method="gather",
                             fuse_spmm_ema=False, device=card)
        for it, got in per.items():
            colors = coloring_for_seed(4 * 1_000_003 + it, d.n_pad, g.n, 7,
                                       device=card)[:g.n]
            assert got == float(eng.count_colorful(colors)[0])
    finally:
        dist.destroy_process_group()


def _close_to_largest(got, want, rtol, atol=1e-6):
    """Card against CPU: every element within ``atol + rtol * max|want|``
    (``index_add_`` adds with atomics on the card, in no fixed order)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape
    scale = want.abs().max().item() if want.numel() else 0.0
    assert (got - want).abs().max().item() <= atol + rtol * scale


@pytest.mark.parametrize("arch_id", ["graphsage-reddit", "pna", "gatedgcn"])
def test_gnn_forward_and_backward_on_card_match_cpu(card, arch_id):
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import gnn_batch
    from repro_torch.models.gnn import build_gnn, gnn_forward, gnn_loss
    arch = reduced_config(arch_id)
    models = {}
    for dev in ("cpu", card):
        batch = gnn_batch(arch, "smoke_full", 3, device=dev)
        model = build_gnn(arch.model, 9, device="cpu").to(dev)
        out = gnn_forward(model, batch)
        gnn_loss(model, batch).backward()
        models[str(dev)] = (out, model)
    (out_c, m_c), (out_g, m_g) = models["cpu"], models[str(card)]
    _close_to_largest(out_g, out_c, 1e-5)
    for p_c, p_g in zip(m_c.parameters(), m_g.parameters()):
        assert (p_c.grad is None) == (p_g.grad is None)
        if p_c.grad is not None:
            _close_to_largest(p_g.grad, p_c.grad, 1e-5)


def test_nequip_energy_forces_and_backward_on_card_match_cpu(card):
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import gnn_batch
    from repro_torch.models.equivariant import (build_nequip,
                                                nequip_energy_loss,
                                                nequip_forces)
    arch = reduced_config("nequip")
    got = {}
    for dev in ("cpu", card):
        batch = gnn_batch(arch, "smoke_molecule", 3, device=dev)
        model = build_nequip(arch.model, device="cpu").to(dev)
        energy, forces = nequip_forces(model, batch)
        nequip_energy_loss(model, batch).backward()
        got[str(dev)] = (energy, forces, [p.grad for p in model.parameters()])
    (e_c, f_c, g_c), (e_g, f_g, g_g) = got["cpu"], got[str(card)]
    _close_to_largest(e_g, e_c, 1e-5)
    _close_to_largest(f_g, f_c, 1e-5)
    for a, b in zip(g_g, g_c):
        # the last layer's l>0 mixers and gates reach no energy
        assert (a is None) == (b is None)
        if b is not None:
            _close_to_largest(a, b, 1e-5)
