// The sparse walks of a destination tile's block run: only each block's
// nonzeros, never the dense 128 x 128 product. Two forms: the BSR SpMM's
// (spmm_bsr.cu), which sums 32 table rows in registers over the whole
// tile, and the fused and group kernels' (fused_spmm_ema.cu,
// fused_spmm_ema_shared.cu), which sum every table row into a TV-column
// slice of y in shared memory.
//
// Operand: besides the destination-sorted block stream (src_tile,
// tile_ptr as in bsr_tile.cuh), each block's nonzeros by destination
// column — col_ptr[b * (TILE + 1) + c] .. col_ptr[b * (TILE + 1) + c + 1]
// index nz_src, the source rows of column c inside block b's source tile
// (structure.block_nonzero_index). A road-like graph's block holds ~100
// nonzeros of its 16,384 entries, so the dense product multiplies zeros
// ~150 times for each useful add.
//
// The SpMM's walk: one CUDA block of SP_THREADS owns a whole destination
// tile (all TILE columns) and SP_ROWS rows of the table. For each block of
// the run it stages the source slice m[0 : SP_ROWS, src_tile * TILE : +
// TILE] (each row 512 contiguous bytes in f32) into shared memory with
// cp.async, double-buffered so the next block's slice is in flight while
// this one is summed. Thread t owns column t % TILE and
// SP_ROWS_PER_THREAD consecutive rows; it adds, for each nonzero of its
// column, the staged source value of each of its rows.
//
// The slice walk (bsr_slice_run_accumulate): one CUDA block owns one
// TV-column slice of a destination tile and every row of the table, and
// stages nothing. A slice of a road-like tile lists ~4 sources a column
// over its run; staging source slices (whole, or only the range its
// nonzeros touch) would bring in several times the bytes it sums and,
// behind a ring small enough to leave room for y, keep too few in flight
// (PERF.md §6). Each thread loads its column's listed sources
// straight into registers, 16 table rows at once; the 32 columns of a
// warp share their lines through L1.
//
// Both walks fix the order of the sums (blocks in run order, a column's
// sources ascending) and use no atomics.
#pragma once

#include <cstdint>

#include "bsr_tile.cuh"

namespace rt {

constexpr int SP_THREADS = 256;
constexpr int SP_ROWS = 32;  // table rows per CUDA block
constexpr int SP_COL_THREADS = SP_THREADS / TILE;  // threads per column
constexpr int SP_ROWS_PER_THREAD = SP_ROWS / SP_COL_THREADS;

// dynamic shared memory of the walk: two staged slices
template <typename T>
constexpr int sparse_smem_bytes() {
  return 2 * SP_ROWS * TILE * (int)sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// buf[r * TILE + i] = m[r * n + src0 + i] for r < rows and src0 + i < n,
// zero elsewhere, as one committed cp.async group. With vec, rows start on
// 16-byte boundaries and n is a multiple of the vector, so a 16-byte piece
// is wholly in or out; without, the copy is element by element.
template <typename T>
__device__ __forceinline__ void sparse_stage(T* buf, const T* __restrict__ m,
                                             long long n, int rows,
                                             long long src0, bool vec) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PIECES = TILE / VEC;
  if (vec) {
    for (int i = threadIdx.x; i < SP_ROWS * PIECES; i += SP_THREADS) {
      const int r = i / PIECES, q = i % PIECES;
      const long long v = src0 + q * VEC;
      const bool in = r < rows && v < n;
      cp_async16(buf + r * TILE + q * VEC, in ? m + (long long)r * n + v : m,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < SP_ROWS * TILE; i += SP_THREADS) {
      const int r = i / TILE, c = i % TILE;
      const long long v = src0 + c;
      buf[i] = r < rows && v < n ? m[(long long)r * n + v] : from_f32<T>(0.f);
    }
  }
  cp_async_commit();
}

// acc[k] = sum over the run's blocks b and the nonzeros i of column
// threadIdx.x % TILE of m[(row0 + k) * n + src_tile[b] * TILE + i], with
// row0 = (threadIdx.x / TILE) * SP_ROWS_PER_THREAD; rows >= `rows` sum
// zeros. m_s is 16-byte aligned shared memory of sparse_smem_bytes<T>().
// Every thread of the block must call it (it holds barriers).
template <typename T>
__device__ void bsr_sparse_run_accumulate(
    const T* __restrict__ m, long long n, int rows,
    const int* __restrict__ src_tile, const int* __restrict__ col_ptr,
    const unsigned char* __restrict__ nz_src, int blk_lo, int blk_hi, T* m_s,
    float (&acc)[SP_ROWS_PER_THREAD]) {
  const int c = threadIdx.x % TILE;
  const int row0 = (threadIdx.x / TILE) * SP_ROWS_PER_THREAD;
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool vec =
      n % VEC == 0 && (reinterpret_cast<std::uintptr_t>(m) & 15) == 0;
#pragma unroll
  for (int k = 0; k < SP_ROWS_PER_THREAD; ++k) acc[k] = 0.f;
  if (blk_lo >= blk_hi) return;  // uniform over the block
  sparse_stage(m_s, m, n, rows, (long long)src_tile[blk_lo] * TILE, vec);
  for (int b = blk_lo; b < blk_hi; ++b) {
    const T* cur = m_s + ((b - blk_lo) & 1) * SP_ROWS * TILE;
    const int* cp = col_ptr + (long long)b * (TILE + 1) + c;
    const int lo = cp[0], hi = cp[1];
    if (b + 1 < blk_hi) {
      // the other buffer's readers finished at the last iteration's barrier
      sparse_stage(m_s + ((b + 1 - blk_lo) & 1) * SP_ROWS * TILE, m, n, rows,
                   (long long)src_tile[b + 1] * TILE, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block b's slice is in shared memory for all
    const T* ms = cur + row0 * TILE;
    for (int j = lo; j < hi; ++j) {
      const int i = nz_src[j];
#pragma unroll
      for (int k = 0; k < SP_ROWS_PER_THREAD; ++k)
        acc[k] += to_f32(ms[k * TILE + i]);
    }
    __syncthreads();  // this buffer may be staged again
  }
}

// The m_a slice of the fused and group kernels, kept in shared memory
// when its c_a rows fit A_SLICE_BYTES: a_s[r * TV + i] = ma[r * n + v0 +
// i] for r < c_a, zero past n; one committed cp.async group when rows
// start on 16-byte boundaries, else element by element
constexpr int A_SLICE_BYTES = 32768;

template <typename T>
__device__ __forceinline__ void stage_slice(T* a_s, const T* ma, int c_a,
                                            long long n, long long v0) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PIECES = TV / VEC;
  if (n % VEC == 0 && (reinterpret_cast<std::uintptr_t>(ma) & 15) == 0) {
    for (int i = threadIdx.x; i < c_a * PIECES; i += THREADS) {
      const int r = i / PIECES, q = i % PIECES;
      const long long v = v0 + q * VEC;
      const bool in = v < n;
      cp_async16(a_s + r * TV + q * VEC, in ? ma + r * n + v : ma,
                 in ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < c_a * TV; i += THREADS) {
      const long long v = v0 + i % TV;
      a_s[i] = v < n ? ma[(i / TV) * n + v] : from_f32<T>(0.f);
    }
  }
}

// ------------------------------------------------------ the slice walk
constexpr int SLICES = TILE / TV;        // column slices of a tile
constexpr int SL_GROUPS = THREADS / TV;  // row groups of a CUDA block
constexpr int SL_ROWS = 16;              // rows a thread sums side by side

// y[r * TV + c] = sum over the run's blocks b and the nonzeros i of column
// col0 + c of m[r * n + src_tile[b] * TILE + i], for rows r < rows; y is
// shared memory. Thread t owns column t % TV and rows t / TV + SL_GROUPS *
// k, SL_ROWS of them at a time: for each nonzero of its column it loads
// the listed source of each of those rows straight from device memory, so
// SL_ROWS loads a thread are in flight, and the lines a warp's 32 columns
// share are read once through L1. The caller syncs before reading y.
template <typename T>
__device__ void bsr_slice_run_accumulate(
    const T* __restrict__ m, long long n, int rows,
    const int* __restrict__ src_tile, const int* __restrict__ col_ptr,
    const unsigned char* __restrict__ nz_src, int blk_lo, int blk_hi,
    int col0, float* y) {
  const int c = threadIdx.x % TV, g = threadIdx.x / TV;
  for (int r0 = g; r0 < rows; r0 += SL_GROUPS * SL_ROWS) {
    float acc[SL_ROWS];
    const T* row[SL_ROWS];
#pragma unroll
    for (int k = 0; k < SL_ROWS; ++k) {
      acc[k] = 0.f;
      row[k] = m + (long long)(r0 + SL_GROUPS * k) * n;
    }
    for (int b = blk_lo; b < blk_hi; ++b) {
      const long long src0 = (long long)src_tile[b] * TILE;
      const int* cp = col_ptr + (long long)b * (TILE + 1) + col0 + c;
      const int lo = cp[0], hi = cp[1];
      for (int j = lo; j < hi; ++j) {
        const long long v = src0 + nz_src[j];
#pragma unroll
        for (int k = 0; k < SL_ROWS; ++k)
          if (r0 + SL_GROUPS * k < rows) acc[k] += to_f32(__ldg(row[k] + v));
      }
    }
#pragma unroll
    for (int k = 0; k < SL_ROWS; ++k) {
      const int r = r0 + SL_GROUPS * k;
      if (r < rows) y[r * TV + c] = acc[k];
    }
  }
}

}  // namespace rt
