"""Each kernel module of the port against the TPU kernel it replaces.

The port's kernel wrappers run their plain PyTorch versions on CPU tensors
(the CUDA kernels run only on the card, where ``chip_smoke.py`` holds each
against its plain version). Here the same numpy inputs go through the plain
versions and through the JAX package's Pallas kernels in interpret mode:
``spmm`` vs ``spmm_bsr_pallas``, ``ema`` vs ``ema_pallas`` and
``fused_spmm_ema`` vs ``fused_spmm_ema_pallas``. Tolerances are the
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
from repro.kernels.ema.pallas_ema import ema_pallas  # noqa: E402
from repro.kernels.fused.pallas_fused import fused_spmm_ema_pallas  # noqa: E402
from repro.kernels.spmm.pallas_bsr import spmm_bsr_pallas  # noqa: E402
from repro_torch.core.colorsets import split_tables  # noqa: E402
from repro_torch.graph.generators import erdos_renyi, grid_2d  # noqa: E402
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
    before = (spmm_ops.spmm.launches, ema_ops.ema.launches,
              fused_ops.fused_spmm_ema.launches)
    m_a, m_p = torch.ones(2, 5, g.n), torch.ones(2, 10, g.n)
    ema_ops.ema(m_a, spmm_ops.spmm(m_p, prep), ia, ip)
    fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, prep)
    assert (spmm_ops.spmm.launches, ema_ops.ema.launches,
            fused_ops.fused_spmm_ema.launches) == before


def test_bf16_plain_versions_accumulate_in_f32():
    """bf16 storage, f32 sums: 300 ones sum to 300 (exact in bf16) before
    the one rounding at the store; summed in bf16 they stall at 256."""
    ia = torch.zeros((1, 300), dtype=torch.int32)
    ones = torch.ones(1, 1, 3, dtype=torch.bfloat16)
    out = ema_ops.ema(ones, ones, ia, ia)
    assert out.dtype == torch.bfloat16
    assert out.float().tolist() == [[[300.0, 300.0, 300.0]]]
