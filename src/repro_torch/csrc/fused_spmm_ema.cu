// Fused SpMM -> eMA: out = ema(m_a, m_p @ A, IA, IP) without writing
// y = m_p @ A to device memory.
//
// Replaces the TPU kernel fused_spmm_ema_pallas (src/repro/kernels/fused/
// pallas_fused.py, _kernel and fused_spmm_ema_pallas), which accumulated y
// in VMEM over a sequential grid axis and applied the split combination as
// one-hot selection matmuls on the MXU, with bb colourings per step.
//
// Here one CUDA block owns (destination tile, TV-column slice, colouring b):
//   1. it accumulates y[c_p, TV] in dynamic shared memory over the tile's
//      block run (bsr_tile.cuh), ending in a barrier;
//   2. it writes out[b, j, v] = sum_l m_a[b, IA[j, l], v] * y[IP[j, l], v]
//      for every j straight to device memory, indexing rows of y in shared
//      memory directly (no selection matmuls). Warp w takes rows w, w + 8,
//      ...; lane c takes column c, so m_a reads and out writes coalesce.
// The batch is a grid dimension, not a block of colourings per step. Sums
// are f32 for f32 and bf16 storage.
//
// What bounds it on the H100: the dense-block SpMM leg on CUDA cores
// (~150x the useful multiply-adds on a road-like graph), then shared
// memory: y takes c_p * TV * 4 bytes beside 32 KB of staging, so
// c_p <= 1,560 fits the 227 KB a block may have (kernels/fused/ops.py
// holds the fit model that admits plan nodes).
#include "bsr_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::THREADS)
    fused_kernel(const T* __restrict__ m_a, const T* __restrict__ m_p,
                 const int* __restrict__ ia, const int* __restrict__ ip,
                 int s, int l, int c_a, int c_p, long long n,
                 const T* __restrict__ blocks,
                 const int* __restrict__ src_tile,
                 const int* __restrict__ tile_ptr, T* __restrict__ out) {
  extern __shared__ float smem[];
  float* blk_s = smem;
  float* m_s = blk_s + rt::TILE * rt::TV;
  float* y = m_s + rt::STAGE * rt::TILE;
  const int slices = rt::TILE / rt::TV;
  const int tile = blockIdx.x / slices;
  const int col0 = (blockIdx.x % slices) * rt::TV;
  const long long b = blockIdx.y;
  rt::bsr_run_accumulate(m_p + b * c_p * n, n, c_p, blocks, src_tile,
                         tile_ptr[tile], tile_ptr[tile + 1], col0, y, blk_s,
                         m_s);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long v = (long long)tile * rt::TILE + col0 + lane;
  if (v >= n) return;
  const T* ma = m_a + b * c_a * n + v;
  T* o = out + b * s * n + v;
  for (int j = warp; j < s; j += rt::WARPS) {
    const int* a_idx = ia + j * l;
    const int* p_idx = ip + j * l;
    float acc = 0.f;
    for (int q = 0; q < l; ++q)
      acc += rt::to_f32(ma[a_idx[q] * n]) * y[p_idx[q] * rt::TV + lane];
    o[j * n] = rt::from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* m_a, const void* m_p, const int* ia, const int* ip,
           int s, int l, int c_a, int c_p, long long n, int batch,
           const void* blocks, const int* src_tile, const int* tile_ptr,
           int n_tiles, void* out, cudaStream_t stream) {
  const long long smem =
      (long long)(rt::WALK_SMEM_FLOATS + c_p * rt::TV) * sizeof(float);
  if (smem > rt::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_tiles * (rt::TILE / rt::TV), batch);
  fused_kernel<T><<<grid, rt::THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(m_a), static_cast<const T*>(m_p), ia, ip, s, l,
      c_a, c_p, n, static_cast<const T*>(blocks), src_tile, tile_ptr,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Tables are contiguous (batch, rows, n).
// Returns the cudaError_t of the launch.
extern "C" int rt_fused_spmm_ema(int dtype, const void* m_a,
                                 const void* m_p, const int* ia,
                                 const int* ip, int s, int l, int c_a,
                                 int c_p, long long n, int batch,
                                 const void* blocks, const int* src_tile,
                                 const int* tile_ptr, int n_tiles, void* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(m_a, m_p, ia, ip, s, l, c_a, c_p, n, batch, blocks,
                         src_tile, tile_ptr, n_tiles, out, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(m_a, m_p, ia, ip, s, l, c_a, c_p, n, batch,
                                 blocks, src_tile, tile_ptr, n_tiles, out, st);
  return (int)cudaErrorInvalidValue;
}
