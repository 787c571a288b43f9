"""Graph structures for PGBSC.

The host-side canonical representation is CSR (numpy). Device-side formats are
derived on demand:

* ``edges``        — (src, dst) int32 arrays sorted by dst.
* ``ell``          — padded neighbor lists (n, max_deg) for the
                     vertex-centric (FASCIA/PFASCIA) engines and the
                     ``ell`` SpMM backend.
* ``gather``       — the destination-sorted edge stream with per-vertex and
                     per-destination-tile run pointers, for the gather SpMM.
* ``bsr``          — 128x128 dense-ified adjacency tiles (block-sparse rows)
                     for the shared-passive group kernel, and each block's
                     nonzeros by destination column for the BSR SpMM and
                     the fused kernel.

All formats represent the *reverse* traversal used by the DP: for an undirected
graph, A is symmetric and Y[:, i] = sum_{j in N(i)} M[:, j].

A copy of the JAX package's ``graph/structure.py``. ``fingerprint`` and
``bsr_block_stats`` give the reference's strings and dicts (vertex
reordering publishes the block counts); ``bsr`` and ``ell`` are
vectorised (the same arrays as the reference's loops, tested). The
reference's gather operand, ``edge_chunks``, pads every
(destination tile, source tile) pair to 512-edge chunks so the TPU can
densify each chunk into a 128x128 tile; the card gathers edges directly,
so the port's gather operand (``kernels/spmm/ops.gather_prep_from_edges``)
keeps the plain edge stream instead: on a social graph most tile pairs
hold a few edges, and the padding multiplies the stream (``chip_smoke.py`` prints both sizes for ``rmat(20)``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property

import numpy as np

__all__ = ["Graph", "BsrMatrix", "BsrLayout", "block_nonzero_index"]


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Block-sparse adjacency: dense ``tile x tile`` blocks for nonempty tiles.

    ``blocks[b]`` is the dense sub-matrix A[src_tile*t:(src_tile+1)*t,
    dst_tile*t:(dst_tile+1)*t]; the SpMM computes
    ``Y[:, dst_block] += M[:, src_block] @ blocks[b]``. Blocks are sorted by
    ``dst_tile`` so output blocks are revisited consecutively.
    """

    blocks: np.ndarray    # (n_blocks, tile, tile) float32
    src_tile: np.ndarray  # (n_blocks,) int32
    dst_tile: np.ndarray  # (n_blocks,) int32
    tile: int
    n_tiles: int

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])


@dataclasses.dataclass(frozen=True)
class BsrLayout:
    """The block stream of :class:`BsrMatrix` and each edge's slot in it:
    edge e sets ``blocks[edge_block[e], edge_src[e], edge_dst[e]] = 1``."""

    src_tile: np.ndarray    # (n_blocks,) int32
    dst_tile: np.ndarray    # (n_blocks,) int32, sorted ascending
    edge_block: np.ndarray  # (m,) int64
    edge_src: np.ndarray    # (m,) int64, row inside the block
    edge_dst: np.ndarray    # (m,) int64, column inside the block
    tile: int
    n_tiles: int

    @property
    def n_blocks(self) -> int:
        return int(self.src_tile.shape[0])


def block_nonzero_index(n_blocks: int, tile: int, edge_block, edge_src,
                        edge_dst) -> tuple[np.ndarray, np.ndarray]:
    """The nonzeros of a block stream, block by block and in each block by
    destination column, sources ascending: ``(col_ptr, nz_src)``. Column
    ``c`` of block ``b`` sums the source rows ``nz_src[col_ptr[b, c]:
    col_ptr[b, c + 1]]`` of its source tile; ``col_ptr`` is ``(n_blocks,
    tile + 1)`` int32 of offsets into the whole stream (``col_ptr[b, tile]
    == col_ptr[b + 1, 0]``), ``nz_src`` uint8 rows inside the tile."""
    if tile > 256:
        raise ValueError(f"a uint8 source offset holds tiles up to 256, "
                         f"got {tile}")
    edge_block = np.asarray(edge_block, np.int64)
    edge_src = np.asarray(edge_src, np.int64)
    col = edge_block * tile + np.asarray(edge_dst, np.int64)
    if len(col) >= 1 << 31:
        raise ValueError(f"{len(col)} nonzeros overflow the int32 column "
                         f"pointer")
    order = np.lexsort((edge_src, col))
    # flat[i] = nonzeros before column i of the whole stream; block b's row
    # of col_ptr is the window flat[b * tile : b * tile + tile + 1]
    flat = np.zeros(n_blocks * tile + 1, np.int64)
    np.cumsum(np.bincount(col, minlength=n_blocks * tile), out=flat[1:])
    col_ptr = np.lib.stride_tricks.as_strided(
        flat, shape=(n_blocks, tile + 1),
        strides=(tile * flat.itemsize, flat.itemsize)).astype(np.int32)
    return col_ptr, edge_src[order].astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Simple undirected graph in CSR form (host-side numpy).

    ``indptr``/``indices`` follow scipy conventions. The graph is stored
    symmetrized and deduplicated; self-loops are removed.
    """

    n: int
    indptr: np.ndarray   # (n + 1,) int64
    indices: np.ndarray  # (m,) int32  — column ids, sorted per row

    # ------------------------------------------------------------- builders
    @staticmethod
    def from_edges(n: int, edges: np.ndarray) -> "Graph":
        """Build from an (m, 2) array of (possibly directed/duplicated) edges."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if edges.size:
            if edges.min() < 0 or edges.max() >= n:
                raise ValueError("edge endpoint out of range")
        # symmetrize, drop self loops, dedup
        und = np.concatenate([edges, edges[:, ::-1]], axis=0)
        und = und[und[:, 0] != und[:, 1]]
        if und.size:
            key = und[:, 0] * n + und[:, 1]
            key = np.unique(key)
            src = (key // n).astype(np.int64)
            dst = (key % n).astype(np.int32)
        else:
            src = np.zeros((0,), np.int64)
            dst = np.zeros((0,), np.int32)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return Graph(n=n, indptr=indptr, indices=dst)

    # ------------------------------------------------------------ properties
    @property
    def m(self) -> int:
        """Number of directed edge slots (2x undirected edge count)."""
        return int(self.indices.shape[0])

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    @property
    def avg_degree(self) -> float:
        return float(self.m) / max(1, self.n)

    @cached_property
    def fingerprint(self) -> str:
        """Stable content hash of the CSR structure (32 hex chars), equal
        across processes and machines for equal graphs."""
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64(self.n).tobytes())
        h.update(np.ascontiguousarray(self.indptr, np.int64).tobytes())
        h.update(np.ascontiguousarray(self.indices, np.int32).tobytes())
        return h.hexdigest()

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def to_dense(self) -> np.ndarray:
        a = np.zeros((self.n, self.n), dtype=np.float32)
        src = np.repeat(np.arange(self.n), self.degrees)
        a[src, self.indices] = 1.0
        return a

    # ------------------------------------------------------- device formats
    @cached_property
    def edges_by_dst(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) int32 arrays; CSR is per-dst sorted already (symmetric).

        Because the CSR rows are destination rows for the reverse traversal
        (A symmetric), row i's entries are the sources contributing to dst i.
        """
        dst = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
        src = self.indices.astype(np.int32)
        return src, dst

    def ell(self) -> tuple[np.ndarray, np.ndarray]:
        """Padded neighbor table (n, max_deg) + float mask. Row v lists v's
        neighbors in CSR order, then padding with n-1; at least one column.
        The reference's ``pad_value=`` is left out: nothing sets it."""
        width = max(self.max_degree, 1)
        nbr = np.full((self.n, width), self.n - 1, dtype=np.int32)
        msk = np.zeros((self.n, width), dtype=np.float32)
        row = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        col = np.arange(self.m, dtype=np.int64) - self.indptr[row]
        nbr[row, col] = self.indices
        msk[row, col] = 1.0
        return nbr, msk

    def bsr_layout(self, tile: int = 128) -> "BsrLayout":
        """Where every edge lands in the BSR stream, without the blocks.

        Blocks are the distinct (dst_tile, src_tile) pairs of the edges in
        ascending key order, with one zero filler block per empty
        destination tile, stably merged by destination tile — the order of
        the reference's block loop. Kept apart from :meth:`bsr` so a device
        operand can be densified where it lives (``kernels/spmm/ops``).
        """
        src, dst = self.edges_by_dst
        n_tiles = -(-self.n // tile)
        key = (dst // tile).astype(np.int64) * n_tiles + src // tile
        uniq, edge_block = np.unique(key, return_inverse=True)
        d_occ = (uniq // n_tiles).astype(np.int32)
        s_occ = (uniq % n_tiles).astype(np.int32)
        # Every dst tile needs >= 1 block so its output block is initialized.
        empty = np.setdiff1d(np.arange(n_tiles, dtype=np.int32), d_occ)
        d_all = np.concatenate([d_occ, empty])
        s_all = np.concatenate([s_occ, empty])
        order = np.argsort(d_all, kind="stable")
        slot = np.empty(len(order), np.int64)
        slot[order] = np.arange(len(order))
        return BsrLayout(
            src_tile=s_all[order], dst_tile=d_all[order],
            edge_block=slot[edge_block.ravel()],
            edge_src=(src % tile).astype(np.int64),
            edge_dst=(dst % tile).astype(np.int64),
            tile=tile, n_tiles=n_tiles)

    def bsr(self, tile: int = 128) -> BsrMatrix:
        """Dense-ified tile blocks, sorted by destination tile.

        Block b holds A[src_tile, dst_tile] densified;
        Y[:, dst] += M[:, src] @ block. Efficient after RCM reordering
        concentrates nonzeros near the diagonal.
        """
        lay = self.bsr_layout(tile)
        blocks = np.zeros((lay.n_blocks, tile, tile), np.float32)
        blocks[lay.edge_block, lay.edge_src, lay.edge_dst] = 1.0
        return BsrMatrix(blocks=blocks, src_tile=lay.src_tile,
                         dst_tile=lay.dst_tile, tile=tile,
                         n_tiles=lay.n_tiles)

    def bsr_block_stats(self, tile: int = 128) -> dict:
        """Occupied-block count and density of the ``tile`` BSR layout
        without building any blocks (one unique pass over the edges' tile
        keys). The zero filler blocks of empty destination tiles (see
        :meth:`bsr_layout`) are left out: this counts the blocks that hold
        nonzeros, which vertex reordering tries to shrink.
        """
        n_tiles = -(-self.n // tile)
        if self.m == 0:
            occupied = 0
        else:
            src, dst = self.edges_by_dst
            key = (dst // tile).astype(np.int64) * n_tiles + src // tile
            occupied = int(np.unique(key).size)
        total = n_tiles * n_tiles
        return {
            "tile": tile,
            "n_tiles": n_tiles,
            "occupied_blocks": occupied,
            "total_blocks": total,
            # fraction of the tile grid that is occupied (reordering
            # shrinks it) and nonzeros per occupied block (reordering
            # grows it)
            "block_density": occupied / total if total else 0.0,
            "nnz_per_block": self.m / occupied if occupied else 0.0,
        }

    def padded(self, multiple: int) -> "Graph":
        """Pad vertex count up to a multiple (isolated padding vertices)."""
        n_pad = -(-self.n // multiple) * multiple
        if n_pad == self.n:
            return self
        indptr = np.concatenate(
            [self.indptr, np.full(n_pad - self.n, self.indptr[-1], np.int64)]
        )
        return Graph(n=n_pad, indptr=indptr, indices=self.indices)
