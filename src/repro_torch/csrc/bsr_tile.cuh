// Shared pieces of the port's kernels: the tile constants and the storage
// conversions. No kernel multiplies whole blocks: spmm_bsr.cu,
// fused_spmm_ema.cu and fused_spmm_ema_shared.cu walk only each block's
// nonzeros (bsr_sparse_tile.cuh).
//
// The adjacency is the destination-sorted stream of TILE x TILE {0,1}
// blocks of Graph.bsr(); tile_ptr[t]..tile_ptr[t+1] is destination tile
// t's run (every tile has at least one block). One CUDA block owns one
// destination tile (or one TV-column slice of it) and walks the whole run
// itself: the TPU kernels carried the sum across an "arbitrary" grid axis,
// which a GPU does not have, so here the loop over the run lives inside
// the block. No atomics, and the summation order is fixed.
//
// The Python fit models (kernels/fused/ops.py, fused_smem_bytes and
// fused_group_smem_bytes) mirror TILE, TV and WARPS; change them together.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

constexpr int TILE = 128;     // BSR block edge
constexpr int TV = 32;        // destination columns per CUDA block (a warp)
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
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

}  // namespace rt
