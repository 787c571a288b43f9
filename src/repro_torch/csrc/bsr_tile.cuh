// Shared pieces of the port's kernels: the tile constants and the storage
// conversions, and the dense run walk of the shared-passive group kernel
// (fused_spmm_ema_shared.cu), the only kernel that still multiplies whole
// blocks; spmm_bsr.cu and fused_spmm_ema.cu walk only the nonzeros
// (bsr_sparse_tile.cuh).
//
// The adjacency is the destination-sorted stream of dense TILE x TILE
// {0,1} blocks of Graph.bsr(); tile_ptr[t]..tile_ptr[t+1] is destination
// tile t's run (every tile has at least one block). One CUDA block owns one
// destination tile's TV-column slice and walks the whole run itself: the
// TPU kernels carried the sum across an "arbitrary" grid axis, which a GPU
// does not have, so here the loop over the run lives inside the block. No
// atomics, and the summation order is fixed.
//
// The Python fit model (kernels/fused/ops.py, fused_group_smem_bytes)
// mirrors TILE, TV, STAGE and the dense walk's shared-memory layout below;
// change them together.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

constexpr int TILE = 128;     // BSR block edge
constexpr int TV = 32;        // destination columns per CUDA block (a warp)
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int STAGE = 32;     // source-table rows staged per pass
constexpr int ROWS_PER_WARP = STAGE / WARPS;
// largest dynamic shared memory a block may ask for on sm_90
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements c and c + 1 (c even) of a row in shared memory, as f32
__device__ __forceinline__ float2 pair_at(const float* row, int c) {
  return *reinterpret_cast<const float2*>(row + c);
}
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* row, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
}

// o[0] = v.x and, when both, o[1] = v.y, rounded to T; one store when vec
// (o 8-byte aligned in f32, 4-byte in bf16)
template <typename T>
__device__ __forceinline__ void store_pair(T* o, float2 v, bool both,
                                           bool vec) {
  if (vec) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(o) = v;
    else
      *reinterpret_cast<__nv_bfloat162*>(o) = __float22bfloat162_rn(v);
    return;
  }
  o[0] = from_f32<T>(v.x);
  if (both) o[1] = from_f32<T>(v.y);
}

// Shared floats the run walk needs besides y: one TILE x TV block slice and
// one STAGE x TILE slice of the source table.
constexpr int WALK_SMEM_FLOATS = TILE * TV + STAGE * TILE;

// y[r * TV + c] = sum over the run's blocks b and i < TILE of
//   m[r * n + src_tile[b] * TILE + i] * blocks[b][i][col0 + c]
// for rows r < rows. y, blk_s (TILE * TV) and m_s (STAGE * TILE) are
// shared memory. Columns past n read as zero. Ends with a barrier, so y
// is complete for every thread on return.
template <typename T>
__device__ void bsr_run_accumulate(const T* __restrict__ m, long long n,
                                   int rows, const T* __restrict__ blocks,
                                   const int* __restrict__ src_tile,
                                   int blk_lo, int blk_hi, int col0,
                                   float* y, float* blk_s, float* m_s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < rows * TV; i += THREADS) y[i] = 0.f;
  for (int b = blk_lo; b < blk_hi; ++b) {
    const long long src0 = (long long)src_tile[b] * TILE;
    const T* blk = blocks + (long long)b * TILE * TILE + col0;
    __syncthreads();  // the previous block's readers of blk_s are done
    for (int i = tid; i < TILE * TV; i += THREADS)
      blk_s[i] = to_f32(blk[(i / TV) * TILE + i % TV]);
    for (int r0 = 0; r0 < rows; r0 += STAGE) {
      const int nr = min(STAGE, rows - r0);
      __syncthreads();  // blk_s is staged; earlier readers of m_s are done
      for (int i = tid; i < nr * TILE; i += THREADS) {
        const long long v = src0 + i % TILE;
        m_s[i] = v < n ? to_f32(m[(long long)(r0 + i / TILE) * n + v]) : 0.f;
      }
      __syncthreads();
      // warp w owns chunk rows w, w + WARPS, ...; lane c owns column c.
      // The m_s reads are warp-wide broadcasts, the blk_s reads hit 32
      // distinct banks.
      if (warp < nr) {
        float acc[ROWS_PER_WARP];
#pragma unroll
        for (int q = 0; q < ROWS_PER_WARP; ++q) acc[q] = 0.f;
        for (int i = 0; i < TILE; i += 4) {
          const float a0 = blk_s[(i + 0) * TV + lane];
          const float a1 = blk_s[(i + 1) * TV + lane];
          const float a2 = blk_s[(i + 2) * TV + lane];
          const float a3 = blk_s[(i + 3) * TV + lane];
#pragma unroll
          for (int q = 0; q < ROWS_PER_WARP; ++q) {
            const float4 mv = *reinterpret_cast<const float4*>(
                &m_s[(warp + q * WARPS) * TILE + i]);
            acc[q] += mv.x * a0 + mv.y * a1 + mv.z * a2 + mv.w * a3;
          }
        }
#pragma unroll
        for (int q = 0; q < ROWS_PER_WARP; ++q) {
          const int r = warp + q * WARPS;
          if (r < nr) y[(r0 + r) * TV + lane] += acc[q];
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace rt
