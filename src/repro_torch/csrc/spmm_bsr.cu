// BSR SpMM, Y = M @ A, for a (rows, n) count table M.
//
// Replaces the TPU kernel spmm_bsr_pallas (src/repro/kernels/spmm/
// pallas_bsr.py, _kernel and spmm_bsr_pallas), which walked the
// destination-sorted block stream on a sequential grid axis and kept the
// partial sums in VMEM scratch between steps.
//
// Here one CUDA block owns (destination tile, TV-column slice, SPMM_ROWS
// rows of M) and walks the tile's block run itself (bsr_tile.cuh), so the
// sum needs no atomics and has a fixed order. Sums are f32 for f32 and
// bf16 storage.
//
// What bounds it on the H100: the dense blocks. A block of a road-like
// graph holds ~100 nonzeros of its 16,384 entries, so the block stream is
// most of the bytes (2.55 GB at 1M vertices) and the dense products are
// ~150x the useful multiply-adds, on CUDA cores. The design keeps the
// arithmetic on shared memory (broadcast table reads, conflict-free block
// reads) and reads each block once per column slice; skipping the zeros
// is left to the gather kernel still to be ported.
#include "bsr_tile.cuh"

namespace {

constexpr int SPMM_ROWS = 64;  // rows of M per CUDA block

template <typename T>
__global__ void __launch_bounds__(rt::THREADS)
    spmm_bsr_kernel(const T* __restrict__ m, int rows, long long n,
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
  const int r0 = blockIdx.y * SPMM_ROWS;
  const int nr = min(SPMM_ROWS, rows - r0);
  rt::bsr_run_accumulate(m + (long long)r0 * n, n, nr, blocks, src_tile,
                         tile_ptr[tile], tile_ptr[tile + 1], col0, y, blk_s,
                         m_s);
  const long long v0 = (long long)tile * rt::TILE + col0;
  for (int i = threadIdx.x; i < nr * rt::TV; i += rt::THREADS) {
    const long long v = v0 + i % rt::TV;
    if (v < n)
      out[(long long)(r0 + i / rt::TV) * n + v] = rt::from_f32<T>(y[i]);
  }
}

template <typename T>
int launch(const void* m, int rows, long long n, const void* blocks,
           const int* src_tile, const int* tile_ptr, int n_tiles, void* out,
           cudaStream_t stream) {
  const dim3 grid(n_tiles * (rt::TILE / rt::TV),
                  (rows + SPMM_ROWS - 1) / SPMM_ROWS);
  const int smem =
      (rt::WALK_SMEM_FLOATS + SPMM_ROWS * rt::TV) * (int)sizeof(float);
  spmm_bsr_kernel<T><<<grid, rt::THREADS, smem, stream>>>(
      static_cast<const T*>(m), rows, n, static_cast<const T*>(blocks),
      src_tile, tile_ptr, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (storage; the sums are f32 either way).
// Returns the cudaError_t of the launch.
extern "C" int rt_spmm_bsr(int dtype, const void* m, int rows, long long n,
                           const void* blocks, const int* src_tile,
                           const int* tile_ptr, int n_tiles, void* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(m, rows, n, blocks, src_tile, tile_ptr, n_tiles, out,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(m, rows, n, blocks, src_tile, tile_ptr,
                                 n_tiles, out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
