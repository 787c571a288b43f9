"""State carried from the JAX package into the port.

The port rebuilds its own BSR stream (vectorised ``Graph.bsr``) and split
tables; they must equal the reference's arrays byte for byte. An engine
built through ``repro_torch.interop`` from a reference engine's arrays
gives the reference's totals.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.engines import CountingEngine as RefEngine  # noqa: E402
from repro.graph import Graph as RefGraph  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.coloring import coloring_numpy  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.engines import CountingEngine  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph.structure import Graph  # noqa: E402
from repro_torch.kernels.spmm import ops as spmm_ops  # noqa: E402

def _dense_from_index(prep):
    """The dense (n_blocks, tile, tile) f32 blocks a BSR operand's nonzero
    index stands for, rebuilt on the host."""
    tile = prep.tile
    col_ptr, nz_src = prep.col_ptr.numpy(), prep.nz_src.numpy()
    counts = np.diff(col_ptr, axis=1).ravel()
    col = np.repeat(np.arange(prep.n_blocks * tile), counts)
    dense = np.zeros((prep.n_blocks, tile, tile), np.float32)
    dense[col // tile, nz_src, col % tile] = 1.0
    return dense


GRAPHS = {
    "grid": (lambda: generators.grid_2d(20, 17),
             lambda: ref_gen.grid_2d(20, 17)),
    "er_ragged": (lambda: generators.erdos_renyi(300, 6.0, seed=3),
                  lambda: ref_gen.erdos_renyi(300, 6.0, seed=3)),
    "rmat": (lambda: generators.rmat(9, 8, seed=2),
             lambda: ref_gen.rmat(9, 8, seed=2)),
    "empty": (lambda: Graph.from_edges(200, np.zeros((0, 2), np.int64)),
              lambda: RefGraph.from_edges(200, np.zeros((0, 2), np.int64))),
}


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_bsr_is_byte_identical(gname):
    g, g_ref = (f() for f in GRAPHS[gname])
    got = g.padded(128).bsr()
    want = g_ref.padded(128).bsr()
    for name in ("blocks", "src_tile", "dst_tile"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name
    assert got.n_tiles == want.n_tiles
    # the device operand is the same blocks' nonzero index, and holds no
    # dense stream
    prep = spmm_ops.prepare(g, device="cpu")
    assert not hasattr(prep, "blocks") and prep.n_blocks == want.n_blocks
    assert _dense_from_index(prep).tobytes() == want.blocks.tobytes()
    np.testing.assert_array_equal(prep.dst_tile.numpy(), want.dst_tile)
    ptr = prep.tile_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == prep.n_blocks
    for t in range(prep.n_tiles):
        assert (want.dst_tile[ptr[t]:ptr[t + 1]] == t).all()


@pytest.mark.parametrize("tname", ["u5", "u7", "u12"])
def test_split_tables_and_prep_match_reference_engine(tname):
    g, g_ref = (f() for f in GRAPHS["er_ragged"])
    eng = CountingEngine(g, tname, plan="optimized", device="cpu")
    ref = RefEngine(g_ref, tname, spmm_method="pallas_bsr",
                    use_pallas_ema=True, fuse_spmm_ema=True, plan="optimized")
    assert sorted(eng._splits) == sorted(ref._splits)
    for idx, (ia, ip) in ref._splits.items():
        for got, want in zip(eng._splits[idx], (ia, ip)):
            want = np.asarray(want)
            assert got.numpy().astype(want.dtype).tobytes() == want.tobytes()
    for name in ("blocks", "src_tile", "dst_tile"):
        want = np.asarray(ref._spmm_prep.arrays[name])
        got = (_dense_from_index(eng._spmm_prep) if name == "blocks"
               else getattr(eng._spmm_prep, name).numpy())
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("tname", ["u5", "u12"])
def test_engine_from_reference_state_gives_reference_totals(tname):
    g_ref = GRAPHS["grid"][1]()
    ref = RefEngine(g_ref, tname, spmm_method="pallas_bsr",
                    use_pallas_ema=True, fuse_spmm_ema=True, plan="optimized")
    prep = ref._fused_prep if ref._fused_prep is not None else ref._spmm_prep
    eng = interop.engine_from_state(
        tname, n=g_ref.n, indptr=g_ref.indptr, indices=g_ref.indices,
        bsr={k: np.asarray(prep.arrays[k])
             for k in ("blocks", "src_tile", "dst_tile")},
        splits={i: tuple(np.asarray(a) for a in pair)
                for i, pair in ref._splits.items()},
        device="cpu", plan="optimized")
    cols = np.stack([coloring_numpy(4, i, g_ref.n, eng.k) for i in range(3)])
    got, _ = eng.count_colorful_batch(torch.as_tensor(cols))
    want, _ = ref.count_colorful_batch(jnp.asarray(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_engine_from_state_rejects_mismatched_operand():
    g_ref = GRAPHS["grid"][1]()
    other = ref_gen.grid_2d(40, 40).padded(128).bsr()
    with pytest.raises(ValueError, match="BSR"):
        interop.engine_from_state(
            "u5", n=g_ref.n, indptr=g_ref.indptr, indices=g_ref.indices,
            bsr={"blocks": other.blocks, "src_tile": other.src_tile,
                 "dst_tile": other.dst_tile},
            splits={}, device="cpu")


# a groupable bundle: one unrooted fork rooted two ways (the reference
# suite's _shared_passive_bundle)
BUNDLE = [((0, 1), (1, 2), (0, 3), (0, 4)), ((0, 1), (1, 2), (2, 3), (1, 4))]


def test_bundle_engine_from_reference_state_gives_reference_totals():
    g_ref = GRAPHS["er_ragged"][1]()
    ref = RefEngine(g_ref, BUNDLE, spmm_method="pallas_bsr",
                    use_pallas_ema=True, fuse_spmm_ema=True, plan="dedup")
    assert ref.schedule.fused_groups
    eng = interop.engine_from_state(
        BUNDLE, n=g_ref.n, indptr=g_ref.indptr, indices=g_ref.indices,
        bsr={k: np.asarray(ref._fused_prep.arrays[k])
             for k in ("blocks", "src_tile", "dst_tile")},
        splits={i: tuple(np.asarray(a) for a in pair)
                for i, pair in ref._splits.items()},
        roots=ref.roots, device="cpu", plan="dedup")
    assert eng.fused and eng.schedule.fused_groups
    cols = np.stack([coloring_numpy(6, i, g_ref.n, 5) for i in range(3)])
    got, _ = eng.count_colorful_batch(torch.as_tensor(cols))
    want, _ = ref.count_colorful_batch(jnp.asarray(cols))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_bundle_engine_from_state_rejects_other_roots():
    g_ref = GRAPHS["grid"][1]()
    ref = RefEngine(g_ref, BUNDLE, spmm_method="pallas_bsr",
                    fuse_spmm_ema=True, plan="dedup")
    with pytest.raises(ValueError, match="roots"):
        interop.engine_from_state(
            BUNDLE, n=g_ref.n, indptr=g_ref.indptr,
            indices=g_ref.indices,
            bsr={k: np.asarray(ref._fused_prep.arrays[k])
                 for k in ("blocks", "src_tile", "dst_tile")},
            splits={i: tuple(np.asarray(a) for a in pair)
                    for i, pair in ref._splits.items()},
            roots=ref.roots[::-1], device="cpu", plan="dedup")
