"""The SpMM kernels' operands on the host: the BSR blocks' nonzero index and
the gather stream's hub segments.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` holds
them against their plain versions there). Here the operands they walk are
checked against what they stand for: the nonzero index against the dense
blocks, the hub segments against the edge stream, and a numpy walk of each
operand in the kernel's own order (row chunks, block runs and column lists;
transposed chunks, runs, segments and their partials) against the plain
PyTorch version. Inputs are integer-valued, so f32 sums are exact, but
for one case that holds the BSR walk's order of sums on long runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.graph.generators import erdos_renyi, grid_2d, rmat, star
from repro_torch.graph.structure import Graph
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.kernels.spmm.ops import HUB_DEGREE, RUN_SEG

BSR_GRAPHS = {
    "er_ragged": lambda: erdos_renyi(300, 6.0, seed=3),
    "grid": lambda: grid_2d(12, 11),
    "small": lambda: grid_2d(5, 7),                       # n < one tile
    "empty": lambda: Graph.from_edges(200, np.zeros((0, 2), np.int64)),
}
# rmat(8) at edge factor 32 has 8 hubs above HUB_DEGREE (16 segments), the
# star one of 24 segments
GATHER_CASES = {
    "rmat8": lambda: rmat(8, 32, seed=2),
    "star": lambda: star(3000),
    "er_ragged": BSR_GRAPHS["er_ragged"],
    "empty": BSR_GRAPHS["empty"],
}
# rows of a kernel chunk: the BSR walk's SP_ROWS, the gather's 128-byte
# line of f32
BSR_CHUNK = 32
GATHER_CHUNK = 32


def _table(rows, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(rows, n)).astype(np.float32)


def _bsr(gname, builder):
    g = BSR_GRAPHS[gname]()
    prep = spmm_ops.prepare(g, device="cpu")
    if builder == "from_arrays":
        # the host block stream (the reference carries the same arrays)
        host = g.padded(128).bsr()
        prep = spmm_ops.from_arrays(g.n, host.blocks, host.src_tile,
                                    host.dst_tile, device="cpu")
    return g, prep


@pytest.mark.parametrize("builder", ["prepare", "from_arrays"])
@pytest.mark.parametrize("gname", sorted(BSR_GRAPHS))
def test_bsr_nonzero_index_reproduces_the_blocks(gname, builder):
    g, prep = _bsr(gname, builder)
    col_ptr, nz_src = prep.col_ptr.numpy(), prep.nz_src.numpy()
    tile = prep.tile
    assert col_ptr.dtype == np.int32 and nz_src.dtype == np.uint8
    assert col_ptr.shape == (prep.n_blocks, tile + 1)
    assert col_ptr[0, 0] == 0 and col_ptr[-1, -1] == len(nz_src) == g.m
    np.testing.assert_array_equal(col_ptr[1:, 0], col_ptr[:-1, -1])
    assert (np.diff(col_ptr, axis=1) >= 0).all()
    dense = np.zeros((prep.n_blocks, tile, tile), np.float32)
    for b in range(prep.n_blocks):
        for c in range(tile):
            rows = nz_src[col_ptr[b, c]:col_ptr[b, c + 1]]
            assert (np.diff(rows.astype(np.int64)) > 0).all()  # ascending
            dense[b, rows, c] = 1.0
    np.testing.assert_array_equal(dense, g.padded(128).bsr().blocks)
    assert prep.index_bytes == 4 * col_ptr.size + g.m


def _sparse_walk(m, prep):
    """The BSR SpMM kernel's walk in numpy: per row chunk and destination
    tile, the run's blocks in order, each column's listed sources, each
    RUN_SEG blocks into a zeroed partial added to the total in run
    order."""
    rows, n = m.shape
    tile = prep.tile
    src_tile, tile_ptr = prep.src_tile.numpy(), prep.tile_ptr.numpy()
    col_ptr, nz_src = prep.col_ptr.numpy(), prep.nz_src.numpy()
    padded = np.pad(m, ((0, 0), (0, prep.n_tiles * tile - n)))
    out = np.zeros((rows, prep.n_tiles * tile), np.float32)
    for r0 in range(0, rows, BSR_CHUNK):
        chunk = padded[r0:r0 + BSR_CHUNK]
        for t in range(prep.n_tiles):
            acc = np.zeros((len(chunk), tile), np.float32)
            part = np.zeros_like(acc)
            lo, hi = tile_ptr[t], tile_ptr[t + 1]
            for b in range(lo, hi):
                staged = chunk[:, src_tile[b] * tile:(src_tile[b] + 1) * tile]
                for c in range(tile):
                    for i in nz_src[col_ptr[b, c]:col_ptr[b, c + 1]]:
                        part[:, c] += staged[:, i]
                if (b - lo) % RUN_SEG == RUN_SEG - 1 or b + 1 == hi:
                    acc += part
                    part[:] = 0
            out[r0:r0 + BSR_CHUNK, t * tile:(t + 1) * tile] = acc
    return out[:, :n]


@pytest.mark.parametrize("rows", [1, 70])
@pytest.mark.parametrize("gname", sorted(BSR_GRAPHS))
def test_bsr_sparse_walk_matches_the_plain_spmm(gname, rows):
    g, prep = _bsr(gname, "prepare")
    m = _table(rows, g.n, rows)
    want = spmm_ops.spmm_plain(torch.as_tensor(m), prep).numpy()
    np.testing.assert_array_equal(_sparse_walk(m, prep), want)


def _tiled_graph(n, seed, empty_tile=None):
    """A random graph on ``n`` vertices whose destination tile
    ``empty_tile`` (if any) has no edges (its filler block only)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(6 * n, 2))
    if empty_tile is not None:
        t0 = 128 * empty_tile
        e = e[((e < t0) | (e >= t0 + 128)).all(axis=1)]
    return Graph.from_edges(n, e[e[:, 0] != e[:, 1]])


def _block_product(m, g):
    """The plain SpMM as it was before the dense blocks left the operand:
    each host block multiplied densely into its destination tile."""
    bs = g.padded(128).bsr()
    rows = m.shape[0]
    pad = np.pad(m, ((0, 0), (0, bs.n_tiles * 128 - g.n)))
    pad = pad.reshape(rows, bs.n_tiles, 128)
    out = np.zeros((rows, bs.n_tiles, 128), np.float32)
    for b in range(bs.n_blocks):
        out[:, bs.dst_tile[b]] += pad[:, bs.src_tile[b]] @ bs.blocks[b]
    return out.reshape(rows, -1)[:, :g.n]


# n = 4 tiles + a one-vertex tail, an exact 128-vertex last tile, a graph
# inside one tile; destination tile 1 empty in two of them
PLAIN_GRAPHS = {
    "tail1_empty1": (4 * 128 + 1, 1),
    "tail128_empty1": (3 * 128, 1),
    "tail128": (5 * 128, None),
    "one_tile": (100, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 33])
@pytest.mark.parametrize("case", sorted(PLAIN_GRAPHS))
def test_plain_spmm_over_the_index_equals_the_block_product(case, rows,
                                                            dtype):
    n, empty = PLAIN_GRAPHS[case]
    g = _tiled_graph(n, seed=rows + n, empty_tile=empty)
    if empty is not None:
        dst_tiles = g.padded(128).bsr().dst_tile
        assert (dst_tiles == empty).sum() == 1     # its filler block alone
        src, dst = g.edges_by_dst
        assert not ((dst // 128) == empty).any()
    prep = spmm_ops.prepare(g, dtype=dtype, device="cpu")
    m = _table(rows, g.n, seed=n)
    got = spmm_ops.spmm_plain(torch.as_tensor(m).to(dtype), prep)
    assert got.dtype == dtype
    want = _block_product(m, g)
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.as_tensor(want).to(dtype).float()
                                  .numpy())


@pytest.mark.parametrize("gname", sorted(BSR_GRAPHS))
def test_bsr_prep_holds_no_dense_stream(gname):
    g, prep = _bsr(gname, "prepare")
    tensors = {f.name: getattr(prep, f.name)
               for f in dataclasses.fields(prep)
               if isinstance(getattr(prep, f.name), torch.Tensor)}
    assert set(tensors) == {"src_tile", "dst_tile", "tile_ptr", "col_ptr",
                            "nz_src"}
    assert not hasattr(prep, "blocks")
    assert prep.nbytes == sum(t.numel() * t.element_size()
                              for t in tensors.values())
    # the index is 4 bytes a column and 1 an edge, not 4 bytes an entry
    assert prep.nbytes < prep.n_blocks * 128 * 128 * 4 // 10
    assert (prep.n_blocks, prep.device, prep.dtype) == (
        g.padded(128).bsr().n_blocks, torch.device("cpu"), torch.float32)


def test_bsr_walk_sums_long_runs_in_segments():
    # runs of 40 blocks (3 segments) and real-valued rows: the plain SpMM
    # adds in the kernels' order, bit for bit
    g = erdos_renyi(40 * 128, 40.0, seed=1)
    prep = spmm_ops.prepare(g, device="cpu")
    assert int(prep.tile_ptr.diff().max()) > 2 * RUN_SEG
    m = np.random.default_rng(0).standard_normal((3, g.n)).astype(np.float32)
    want = spmm_ops.spmm_plain(torch.as_tensor(m), prep).numpy()
    np.testing.assert_array_equal(_sparse_walk(m, prep), want)


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_hub_segments_cover_each_edge_once_in_stream_order(case):
    g = GATHER_CASES[case]()
    prep = spmm_ops.prepare(g, "gather", device="cpu")
    hub_degree = prep.hub_degree
    assert hub_degree == HUB_DEGREE
    row_ptr = prep.row_ptr.numpy()
    deg = np.diff(row_ptr)
    hubs = prep.hub_vertex.numpy()
    seg_ptr, seg = prep.hub_seg_ptr.numpy(), prep.seg.numpy()
    np.testing.assert_array_equal(hubs, np.flatnonzero(deg > hub_degree))
    assert seg_ptr[0] == 0 and seg_ptr[-1] == len(seg) == prep.n_segments
    covered = np.zeros(g.m, np.int64)
    for v in np.flatnonzero(deg <= hub_degree):       # the runs walked whole
        covered[row_ptr[v]:row_ptr[v + 1]] += 1
    for h, v in enumerate(hubs):
        mine = seg[seg_ptr[h]:seg_ptr[h + 1]]
        # consecutive, in stream order, and cut at hub_degree edges
        assert mine[0, 0] == row_ptr[v] and mine[-1, 1] == row_ptr[v + 1]
        np.testing.assert_array_equal(mine[1:, 0], mine[:-1, 1])
        assert (mine[:, 1] - mine[:, 0] <= hub_degree).all()
        assert (mine[:-1, 1] - mine[:-1, 0] == hub_degree).all()
        for lo, hi in mine:
            covered[lo:hi] += 1
    assert (covered == 1).all()
    if case in ("rmat8", "star"):
        assert prep.n_hubs >= 1 and prep.n_segments >= 3


def test_star_hub_spans_its_segments_and_none_without_a_split():
    g = star(3000)
    prep = spmm_ops.prepare(g, "gather", device="cpu")
    assert prep.hub_vertex.tolist() == [0]
    assert prep.n_segments == -(-2999 // HUB_DEGREE) >= 3
    whole = spmm_ops._gather_prep(g, "cpu", hub_degree=g.n)
    assert (whole.n_hubs, whole.n_segments) == (0, 0)
    with pytest.raises(ValueError):
        spmm_ops._gather_prep(g, "cpu", hub_degree=0)


def _gather_walk(m, prep):
    """The gather kernel's walk in numpy: per chunk of rows, the
    vertex-major scratch, every run of at most hub_degree edges summed
    whole, each hub's segments into partials added in segment order."""
    rows, n = m.shape
    row_ptr, src = prep.row_ptr.numpy(), prep.src.numpy()
    hub_degree = prep.hub_degree
    seg, seg_ptr = prep.seg.numpy(), prep.hub_seg_ptr.numpy()
    out = np.full((rows, n), np.nan, np.float32)
    for r0 in range(0, rows, GATHER_CHUNK):
        scratch = np.zeros((n, GATHER_CHUNK), np.float32)
        nr = min(GATHER_CHUNK, rows - r0)
        scratch[:, :nr] = m[r0:r0 + nr].T
        for v in range(n):
            lo, hi = row_ptr[v], row_ptr[v + 1]
            if hi - lo <= hub_degree:
                out[r0:r0 + nr, v] = scratch[src[lo:hi]].sum(0)[:nr]
        part = np.stack([scratch[src[lo:hi]].sum(0) for lo, hi in seg]) \
            if len(seg) else np.zeros((0, GATHER_CHUNK), np.float32)
        for h, v in enumerate(prep.hub_vertex.numpy()):
            out[r0:r0 + nr, v] = part[seg_ptr[h]:seg_ptr[h + 1]].sum(0)[:nr]
    return out


@pytest.mark.parametrize("rows", [1, 70])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_chunks_and_hub_split_match_the_plain_gather(case, rows):
    g = GATHER_CASES[case]()
    prep = spmm_ops.prepare(g, "gather", device="cpu")
    m = _table(rows, g.n, rows + 1)
    want = spmm_ops.spmm_gather_plain(torch.as_tensor(m), prep).numpy()
    np.testing.assert_array_equal(_gather_walk(m, prep), want)


@pytest.mark.parametrize("dtype,chunk", [(torch.float32, 32),
                                         (torch.bfloat16, 64)])
def test_gather_scratch_is_one_row_chunk_and_the_partials(dtype, chunk):
    g = GATHER_CASES["rmat8"]()
    prep = spmm_ops.prepare(g, "gather", device="cpu")
    assert prep.n_segments >= 3
    assert prep.scratch_bytes(dtype) == (g.n * chunk * dtype.itemsize
                                         + prep.n_segments * chunk * 4)
