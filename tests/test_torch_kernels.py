"""Each kernel module of the port against the TPU kernel it replaces.

The port's kernel wrappers run their plain PyTorch versions on CPU tensors
(the CUDA kernels run only on the card, where ``chip_smoke.py`` holds each
against its plain version). Here the same numpy inputs go through the plain
versions and through the JAX package's Pallas kernels in interpret mode:
``spmm`` vs ``spmm_bsr_pallas``, ``ema`` vs ``ema_pallas``,
``fused_spmm_ema`` vs ``fused_spmm_ema_pallas``, ``fused_spmm_ema_shared``
vs the reference's ``fused_spmm_ema_shared`` (its Pallas group kernel) and
``spmm(..., "gather")`` vs ``spmm_gather_pallas``. Tolerances are the
reference suite's: ``rtol=1e-6`` in f32 (integer-valued tables, exact in
practice) and ``1e-2`` relative for bf16 storage.
"""

from math import comb

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graph.generators import erdos_renyi as ref_erdos_renyi  # noqa: E402
from repro.graph.generators import grid_2d as ref_grid_2d  # noqa: E402
from repro.graph.generators import rmat as ref_rmat  # noqa: E402
from repro.graph.structure import Graph as RefGraph  # noqa: E402
from repro.kernels.ema.pallas_ema import ema_pallas  # noqa: E402
from repro.kernels.fused.ops import \
    fused_spmm_ema_shared as ref_fused_shared  # noqa: E402
from repro.kernels.fused.ops import prepare_fused  # noqa: E402
from repro.kernels.fused.pallas_fused import fused_spmm_ema_pallas  # noqa: E402
from repro.kernels.spmm.pallas_gather import spmm_gather_pallas  # noqa: E402
from repro.kernels.spmm.pallas_bsr import spmm_bsr_pallas  # noqa: E402
from repro_torch.core.colorsets import split_tables  # noqa: E402
from repro_torch.graph.generators import erdos_renyi, grid_2d, rmat  # noqa: E402
from repro_torch.graph.structure import Graph  # noqa: E402
from repro_torch.kernels.ema import ops as ema_ops  # noqa: E402
from repro_torch.kernels.fused import ops as fused_ops  # noqa: E402
from repro_torch.kernels.spmm import ops as spmm_ops  # noqa: E402

# port graph, reference graph: ragged N (not a multiple of 128) and a grid
GRAPHS = {
    "er_ragged": (lambda: erdos_renyi(300, 6.0, seed=3),
                  lambda: ref_erdos_renyi(300, 6.0, seed=3)),
    "grid": (lambda: grid_2d(12, 11), lambda: ref_grid_2d(12, 11)),
}
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-6),
          "bf16": (torch.bfloat16, jnp.bfloat16, 1e-2)}


def _table(rng, shape):
    return rng.integers(0, 4, size=shape).astype(np.float32)


def _to_jax(a, jdt):
    return jnp.asarray(a).astype(jdt)


def _to_torch(a, tdt):
    return torch.as_tensor(a).to(tdt)


def _assert_close(got_torch, want_jax, rtol):
    got = got_torch.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want_jax, jnp.float32), np.float64)
    assert got.shape == want.shape
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert rel.max(initial=0.0) <= rtol


def _ref_blocks(g_ref):
    bs = g_ref.padded(128).bsr(128)
    return bs, jnp.asarray(bs.src_tile), jnp.asarray(bs.dst_tile)


def _pad_n(a, n_pad):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n_pad - a.shape[-1])])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("b", [1, 3])
def test_spmm_matches_pallas_bsr(dt, gname, b):
    tdt, jdt, rtol = DTYPES[dt]
    g, g_ref = (f() for f in GRAPHS[gname])
    rng = np.random.default_rng(b)
    m = _table(rng, (b, 20, g.n))
    prep = spmm_ops.prepare(g, dtype=tdt, device="cpu")
    got = spmm_ops.spmm(_to_torch(m, tdt), prep)
    bs, st, dtile = _ref_blocks(g_ref)
    n_pad = bs.n_tiles * 128
    flat = _pad_n(m.reshape(b * 20, g.n), n_pad)
    want = spmm_bsr_pallas(_to_jax(flat, jdt), _to_jax(bs.blocks, jdt), st,
                           dtile, n_tiles=bs.n_tiles, tile=128, c_block=8,
                           interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))[:, :g.n]
    _assert_close(got, want.reshape(b, 20, g.n), rtol)


# (k, t, t_a): S = C(k, t) not a multiple of 8 in each case
SPLITS = [(5, 3, 1), (7, 4, 2), (12, 7, 6)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k,t,ta", SPLITS)
@pytest.mark.parametrize("b", [1, 3])
def test_ema_matches_pallas(dt, k, t, ta, b):
    tdt, jdt, rtol = DTYPES[dt]
    n = 300
    ia, ip = split_tables(k, t, ta)
    rng = np.random.default_rng(k + b)
    m_a = _table(rng, (b, comb(k, ta), n))
    y_p = _table(rng, (b, comb(k, t - ta), n))
    got = ema_ops.ema(_to_torch(m_a, tdt), _to_torch(y_p, tdt),
                      torch.as_tensor(ia), torch.as_tensor(ip))
    want = ema_pallas(_to_jax(m_a, jdt), _to_jax(y_p, jdt), jnp.asarray(ia),
                      jnp.asarray(ip), interpret=True)
    _assert_close(got, want, rtol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("k,t,ta", SPLITS[:2])
@pytest.mark.parametrize("b", [1, 3])
def test_fused_matches_pallas(dt, gname, k, t, ta, b):
    tdt, jdt, rtol = DTYPES[dt]
    g, g_ref = (f() for f in GRAPHS[gname])
    ia, ip = split_tables(k, t, ta)
    rng = np.random.default_rng(10 * k + b)
    m_a = _table(rng, (b, comb(k, ta), g.n))
    m_p = _table(rng, (b, comb(k, t - ta), g.n))
    prep = spmm_ops.prepare(g, dtype=tdt, device="cpu")
    got = fused_ops.fused_spmm_ema(
        _to_torch(m_a, tdt), _to_torch(m_p, tdt), torch.as_tensor(ia),
        torch.as_tensor(ip), prep)
    bs, st, dtile = _ref_blocks(g_ref)
    n_pad = bs.n_tiles * 128
    want = fused_spmm_ema_pallas(
        _to_jax(_pad_n(m_a, n_pad), jdt), _to_jax(_pad_n(m_p, n_pad), jdt),
        jnp.asarray(ia), jnp.asarray(ip), _to_jax(bs.blocks, jdt), st, dtile,
        n_tiles=bs.n_tiles, tile=128, interpret=True)
    _assert_close(got, np.asarray(jnp.asarray(want, jnp.float32))[..., :g.n],
                  rtol)


def _shared_inputs(n, b, rng):
    """The two-consumer group of ``TestSharedPassiveKernel``
    (tests/test_kernels_fused.py): one passive of C(5,2) sets read by
    (k=5, t=5, t_a=3) and (k=5, t=4, t_a=2) — different c_a, S, L."""
    m_p = _table(rng, (b, comb(5, 2), n))
    m_as, ias, ips = [], [], []
    for t, ta in ((5, 3), (4, 2)):
        ia, ip = split_tables(5, t, ta)
        ias.append(ia)
        ips.append(ip)
        m_as.append(_table(rng, (b, comb(5, ta), n)))
    return m_as, m_p, ias, ips


SHARED_GRAPHS = dict(GRAPHS, empty=(
    lambda: Graph.from_edges(200, np.zeros((0, 2), np.int64)),
    lambda: RefGraph.from_edges(200, np.zeros((0, 2), np.int64))))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("gname", sorted(SHARED_GRAPHS))
@pytest.mark.parametrize("b", [1, 3])
def test_shared_group_matches_pallas(dt, gname, b):
    tdt, jdt, rtol = DTYPES[dt]
    g, g_ref = (f() for f in SHARED_GRAPHS[gname])
    m_as, m_p, ias, ips = _shared_inputs(g.n, b, np.random.default_rng(b))
    prep = spmm_ops.prepare(g, dtype=tdt, device="cpu")
    got = fused_ops.fused_spmm_ema_shared(
        [_to_torch(m, tdt) for m in m_as], _to_torch(m_p, tdt),
        [torch.as_tensor(a) for a in ias], [torch.as_tensor(a) for a in ips],
        prep)
    want = ref_fused_shared(
        [_to_jax(m, jdt) for m in m_as], _to_jax(m_p, jdt),
        [jnp.asarray(a) for a in ias], [jnp.asarray(a) for a in ips],
        prepare_fused(g_ref, dtype=jdt, interpret=True))
    assert len(got) == len(want) == 2
    for a, w in zip(got, want):
        _assert_close(a, w, rtol)


def test_shared_group_plain_is_one_spmm_then_one_ema_each():
    g = grid_2d(9, 13)
    prep = spmm_ops.prepare(g, device="cpu")
    m_as, m_p, ias, ips = (
        [torch.as_tensor(m) for m in x] if isinstance(x, list)
        else torch.as_tensor(x)
        for x in _shared_inputs(g.n, 2, np.random.default_rng(0)))
    before = fused_ops.fused_spmm_ema_shared.launches
    got = fused_ops.fused_spmm_ema_shared(m_as, m_p, ias, ips, prep)
    assert fused_ops.fused_spmm_ema_shared.launches == before
    y = spmm_ops.spmm(m_p, prep)
    for out, m_a, ia, ip in zip(got, m_as, ias, ips):
        assert torch.equal(out, ema_ops.ema(m_a, y, ia, ip))
        assert torch.equal(out, fused_ops.fused_spmm_ema(m_a, m_p, ia, ip,
                                                         prep))
    with pytest.raises(ValueError, match="per consumer"):
        fused_ops.fused_spmm_ema_shared(m_as, m_p, ias[:1], ips, prep)


def test_group_fit_model():
    """The census roots' group (c_p = 252) fits with room to spare; the
    card's limit is c_p <= 1,552 for a group (a 32 KB m_a slice, y and 8
    warps' split partials, y and the partials in f32), and at most
    MAX_GROUP consumers."""
    assert fused_ops.fused_group_smem_bytes(252) \
        == 32 * 1024 + 252 * 32 * 4 + 8 * 32 * 4 \
        == (128 * 32 + 32 * 128 + 252 * 32 + 8 * 32) * 4
    assert fused_ops.fused_group_fits_smem(4, 252)
    assert fused_ops.fused_group_fits_smem(2, 1552, torch.bfloat16)
    assert fused_ops.fused_group_fits_smem(2, 1552)
    assert not fused_ops.fused_group_fits_smem(2, 1553)
    assert not fused_ops.fused_group_fits_smem(2, 1553, torch.bfloat16)
    assert fused_ops.fused_group_fits_smem(fused_ops.MAX_GROUP, 252)
    assert not fused_ops.fused_group_fits_smem(fused_ops.MAX_GROUP + 1, 252)
    assert not fused_ops.fused_group_fits_smem(0, 252)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_group_layout_is_the_fused_layout_and_the_partials(dt):
    """The group kernel's block holds what the fused kernel's does (the m_a
    slice beside y) plus the 8 warps' split partials, at every c_p the
    group fit model admits."""
    for c_p in range(1, 1553):
        assert fused_ops.fused_group_smem_bytes(c_p, dt) \
            == fused_ops.fused_smem_bytes(c_p, dt) + 8 * 32 * 4


GATHER_GRAPHS = {
    "rmat8": (lambda: rmat(8, 8, seed=2), lambda: ref_rmat(8, 8, seed=2)),
    "er_ragged": GRAPHS["er_ragged"],
    "empty": SHARED_GRAPHS["empty"],
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("gname", sorted(GATHER_GRAPHS))
@pytest.mark.parametrize("b", [1, 3])
def test_gather_matches_pallas_gather(dt, gname, b):
    tdt, jdt, rtol = DTYPES[dt]
    g, g_ref = (f() for f in GATHER_GRAPHS[gname])
    rng = np.random.default_rng(b + 7)
    m = _table(rng, (b, 20, g.n))
    prep = spmm_ops.prepare(g, "gather", device="cpu")
    got = spmm_ops.spmm(_to_torch(m, tdt), prep)
    ch = g_ref.padded(128).edge_chunks(tile=128, chunk_size=512)
    n_pad = ch.n_tiles * 128
    flat = _pad_n(m.reshape(b * 20, g.n), n_pad)
    want = spmm_gather_pallas(
        _to_jax(flat, jdt), jnp.asarray(ch.src), jnp.asarray(ch.dst_local),
        _to_jax(ch.mask, jdt), jnp.asarray(ch.src_tile),
        jnp.asarray(ch.dst_tile), n_tiles=ch.n_tiles, tile=128, c_block=8,
        interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))[:, :g.n]
    _assert_close(got, want.reshape(b, 20, g.n), rtol)


@pytest.mark.parametrize("gname", ["rmat8", "er_ragged"])
def test_gather_operand_is_the_edge_stream(gname):
    """No padding and no blocks: the operand is the destination-sorted
    sources with their run pointers, and agrees with the BSR SpMM."""
    g = GATHER_GRAPHS[gname][0]()
    prep = spmm_ops.prepare(g, "gather", device="cpu")
    src, dst = g.edges_by_dst
    assert prep.src.dtype == torch.int32 and prep.src.numel() == g.m
    assert prep.src.numpy().tobytes() == src.tobytes()
    np.testing.assert_array_equal(prep.row_ptr.numpy(), g.indptr)
    tp = prep.tile_ptr.numpy()
    assert len(tp) == -(-g.n // 128) + 1 and tp[0] == 0 and tp[-1] == g.m
    for t in range(len(tp) - 1):
        assert ((dst[tp[t]:tp[t + 1]] // 128) == t).all()
    assert prep.nbytes == (4 * g.m + 8 * (g.n + 1) + 8 * len(tp)
                           + 4 * prep.n_hubs + 4 * (prep.n_hubs + 1)
                           + 16 * prep.n_segments)
    m = torch.as_tensor(_table(np.random.default_rng(1), (2, 9, g.n)))
    assert torch.equal(spmm_ops.spmm(m, prep),
                       spmm_ops.spmm(m, spmm_ops.prepare(g, device="cpu")))


def test_gather_plain_bounds_its_working_set(monkeypatch):
    """Tile-aligned edge runs: a tiny chunk budget cuts the stream into
    many runs and changes nothing."""
    g = rmat(9, 8, seed=4)
    prep = spmm_ops.prepare(g, "gather", device="cpu")
    m = torch.as_tensor(_table(np.random.default_rng(2), (3, 5, g.n)))
    whole = spmm_ops.spmm(m, prep)
    monkeypatch.setattr(spmm_ops, "_PLAIN_CHUNK_ELEMS", 64)
    assert torch.equal(spmm_ops.spmm(m, prep), whole)


def test_unbatched_tables_keep_their_rank():
    g = grid_2d(5, 7)
    prep = spmm_ops.prepare(g, device="cpu")
    ia, ip = (torch.as_tensor(a) for a in split_tables(5, 3, 1))
    m_a = torch.ones(5, g.n)
    m_p = torch.ones(10, g.n)
    assert spmm_ops.spmm(m_p, prep).shape == (10, g.n)
    assert ema_ops.ema(m_a, spmm_ops.spmm(m_p, prep), ia, ip).shape \
        == (10, g.n)
    assert fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, prep).shape \
        == (10, g.n)


def test_cpu_tensors_run_the_plain_versions_without_launching():
    g = grid_2d(4, 4)
    prep = spmm_ops.prepare(g, device="cpu")
    ia, ip = (torch.as_tensor(a) for a in split_tables(5, 3, 1))
    gather = spmm_ops.prepare(g, "gather", device="cpu")
    counters = (spmm_ops.spmm, spmm_ops.spmm_gather, ema_ops.ema,
                fused_ops.fused_spmm_ema, fused_ops.fused_spmm_ema_shared)
    before = [fn.launches for fn in counters]
    m_a, m_p = torch.ones(2, 5, g.n), torch.ones(2, 10, g.n)
    ema_ops.ema(m_a, spmm_ops.spmm(m_p, prep), ia, ip)
    fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, prep)
    fused_ops.fused_spmm_ema_shared([m_a, m_a], m_p, [ia, ia], [ip, ip],
                                    prep)
    spmm_ops.spmm(m_p, gather)
    assert [fn.launches for fn in counters] == before


def test_bf16_plain_versions_accumulate_in_f32():
    """bf16 storage, f32 sums: 300 ones sum to 300 (exact in bf16) before
    the one rounding at the store; summed in bf16 they stall at 256."""
    ia = torch.zeros((1, 300), dtype=torch.int32)
    ones = torch.ones(1, 1, 3, dtype=torch.bfloat16)
    out = ema_ops.ema(ones, ones, ia, ia)
    assert out.dtype == torch.bfloat16
    assert out.float().tolist() == [[[300.0, 300.0, 300.0]]]
