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
// tile (all TILE columns) and ROWS rows of the table (a template
// parameter: SP_ROWS = 32 by default, 2 to 64 for the autotuner). For each
// block of the run it stages the source slice m[0 : ROWS, src_tile * TILE
// : + TILE] (each row 512 contiguous bytes in f32) into shared memory with
// cp.async, double-buffered so the next block's slice is in flight while
// this one is summed. Thread t owns column t % TILE and ROWS /
// SP_COL_THREADS consecutive rows; it adds, for each nonzero of its
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
// sources ascending) and use no atomics. Each sums a run in segments of
// RUN_SEG blocks, each segment into a zeroed partial that is then added to
// the column's total: a power-law graph's hub tile has a run of thousands
// of blocks, and one f32 chain of a hub column's 64,701 sources
// (rmat(20)) lost 1.7e-5 of u12's estimate against float64, where the
// gather SpMM's 128-edge segments lose 3e-8 (PERF.md §6). A run of at
// most RUN_SEG blocks (every run of a mesh) sums as one chain.
#pragma once

#include <cstdint>

#include "bsr_tile.cuh"

namespace rt {

constexpr int RUN_SEG = 16;  // blocks of a run summed into one partial
constexpr int SP_THREADS = 256;
constexpr int SP_ROWS = 32;  // table rows per CUDA block, by default
constexpr int SP_COL_THREADS = SP_THREADS / TILE;  // threads per column

// dynamic shared memory of the walk: two staged slices of ROWS rows
template <typename T, int ROWS>
constexpr int sparse_smem_bytes() {
  return 2 * ROWS * TILE * (int)sizeof(T);
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
template <typename T, int ROWS>
__device__ __forceinline__ void sparse_stage(T* buf, const T* __restrict__ m,
                                             long long n, int rows,
                                             long long src0, bool vec) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PIECES = TILE / VEC;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * PIECES; i += SP_THREADS) {
      const int r = i / PIECES, q = i % PIECES;
      const long long v = src0 + q * VEC;
      const bool in = r < rows && v < n;
      cp_async16(buf + r * TILE + q * VEC, in ? m + (long long)r * n + v : m,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * TILE; i += SP_THREADS) {
      const int r = i / TILE, c = i % TILE;
      const long long v = src0 + c;
      buf[i] = r < rows && v < n ? m[(long long)r * n + v] : from_f32<T>(0.f);
    }
  }
  cp_async_commit();
}

// acc[k] = sum over the run's blocks b and the nonzeros i of column
// threadIdx.x % TILE of m[(row0 + k) * n + src_tile[b] * TILE + i], with
// row0 = (threadIdx.x / TILE) * (ROWS / SP_COL_THREADS); rows >= `rows`
// sum zeros. m_s is 16-byte aligned shared memory of
// sparse_smem_bytes<T, ROWS>(). Every thread of the block must call it (it
// holds barriers). The sums' order does not depend on ROWS.
template <typename T, int ROWS>
__device__ void bsr_sparse_run_accumulate(
    const T* __restrict__ m, long long n, int rows,
    const int* __restrict__ src_tile, const int* __restrict__ col_ptr,
    const unsigned char* __restrict__ nz_src, int blk_lo, int blk_hi, T* m_s,
    float (&acc)[ROWS / SP_COL_THREADS]) {
  static_assert(ROWS % SP_COL_THREADS == 0, "ROWS splits over a column");
  constexpr int RPT = ROWS / SP_COL_THREADS;  // rows a thread sums
  const int c = threadIdx.x % TILE;
  const int row0 = (threadIdx.x / TILE) * RPT;
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool vec =
      n % VEC == 0 && (reinterpret_cast<std::uintptr_t>(m) & 15) == 0;
  float part[RPT];  // this segment's sums
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc[k] = part[k] = 0.f;
  if (blk_lo >= blk_hi) return;  // uniform over the block
  sparse_stage<T, ROWS>(m_s, m, n, rows, (long long)src_tile[blk_lo] * TILE,
                        vec);
  for (int b = blk_lo; b < blk_hi; ++b) {
    const T* cur = m_s + ((b - blk_lo) & 1) * ROWS * TILE;
    const int* cp = col_ptr + (long long)b * (TILE + 1) + c;
    const int lo = cp[0], hi = cp[1];
    if (b + 1 < blk_hi) {
      // the other buffer's readers finished at the last iteration's barrier
      sparse_stage<T, ROWS>(m_s + ((b + 1 - blk_lo) & 1) * ROWS * TILE, m, n,
                            rows, (long long)src_tile[b + 1] * TILE, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block b's slice is in shared memory for all
    const T* ms = cur + row0 * TILE;
    for (int j = lo; j < hi; ++j) {
      const int i = nz_src[j];
#pragma unroll
      for (int k = 0; k < RPT; ++k) part[k] += to_f32(ms[k * TILE + i]);
    }
    if ((b - blk_lo) % RUN_SEG == RUN_SEG - 1 || b + 1 == blk_hi) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        acc[k] += part[k];
        part[k] = 0.f;
      }
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
// share are read once through L1. A segment's partial sums are added into
// y (the first one stored), so segments cost no registers. The caller
// syncs before reading y.
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
      const int seg = b - blk_lo;
      if (seg % RUN_SEG == RUN_SEG - 1 || b + 1 == blk_hi) {
#pragma unroll
        for (int k = 0; k < SL_ROWS; ++k) {
          const int r = r0 + SL_GROUPS * k;
          if (r < rows)
            y[r * TV + c] = (seg < RUN_SEG ? 0.f : y[r * TV + c]) + acc[k];
          acc[k] = 0.f;
        }
      }
    }
    if (blk_lo >= blk_hi) {
#pragma unroll
      for (int k = 0; k < SL_ROWS; ++k) {
        const int r = r0 + SL_GROUPS * k;
        if (r < rows) y[r * TV + c] = 0.f;
      }
    }
  }
}

}  // namespace rt
