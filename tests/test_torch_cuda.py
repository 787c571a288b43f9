"""The CUDA kernels on the card, at small shapes and their edge cases.

Run on a machine with a CUDA card (and ``nvcc``):
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``. Without a
card every test skips (the ``card`` fixture decides, at run time). Each
kernel is held against its plain PyTorch version on the same device: f32
exactly (integer-valued tables), bf16 within ``1e-2`` relative; the wrappers
must raise on what the kernels do not take, and count only real launches.
"""

from math import comb

import numpy as np
import pytest
import torch

from repro_torch.core.colorsets import split_tables
from repro_torch.core.engines import CountingEngine
from repro_torch.graph.coloring import batch_colorings
from repro_torch.graph.generators import erdos_renyi, grid_2d
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
